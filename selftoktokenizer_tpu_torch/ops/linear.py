"""Linear / MLP / conv primitives on tensors (counterpart of the reference
``ops/linear.py``).

Weights keep torch's layouts (linear ``[out, in]``, conv ``OIHW``) so the
modules' state dicts carry the reference checkpoint names and shapes;
``core/convert.py`` undoes the JAX package's ``[in, out]`` / ``HWIO``
layouts. Feature maps are NHWC at every public function, as in the
reference; convs permute to NCHW inside. Weights are stored fp32 and cast to
the activation dtype at use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from selftoktokenizer_tpu_torch.ops.posembed import timestep_embedding


def linear(x, weight, bias=None):
    """x @ weight.T + bias, weight [out, in] cast to x.dtype at use."""
    return F.linear(x, weight.to(x.dtype),
                    None if bias is None else bias.to(x.dtype))


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def mlp(x, fc1_w, fc1_b, fc2_w, fc2_b, act=None):
    """Two-layer MLP; default act is the tanh-approximate GELU."""
    h = linear(x, fc1_w, fc1_b)
    h = gelu_tanh(h) if act is None else act(h)
    return linear(h, fc2_w, fc2_b)


def conv2d(x, weight, bias=None, stride=1, padding="SAME"):
    """NHWC conv with an OIHW weight. padding: 'SAME' (stride 1) or 'VALID'."""
    kh, kw = weight.shape[2], weight.shape[3]
    if padding == "SAME":
        assert stride == 1, "SAME padding is only used at stride 1"
        pad = (kh // 2, kw // 2)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(padding)
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype),
                 None if bias is None else bias.to(x.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def patch_embed(x, weight, bias, patch: int):
    """Patchify NHWC [B,H,W,C] -> [B, (H/p)*(W/p), D].

    weight: the reference's strided-conv kernel [D, C, p, p]; a p-stride
    p-kernel conv is a matmul over non-overlapping patches, so it is applied
    as one, with the kernel flattened in (p, p, C) order.
    """
    b, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    x = x.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, patch * patch * c)
    w2 = weight.permute(0, 2, 3, 1).reshape(weight.shape[0], -1)
    return linear(x, w2, bias)


def unpatchify(x, patch: int, channels: int, gh: int, gw: int):
    """[B, T, p*p*C] -> NHWC [B, gh*p, gw*p, C]."""
    b = x.shape[0]
    x = x.reshape(b, gh, gw, patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # b gh p gw p c
    return x.reshape(b, gh * patch, gw * patch, channels)


def modulate(x, shift, scale, axis=1):
    """adaLN modulate. shift/scale have one fewer dim than x and are
    broadcast by inserting ``axis``: axis=1 for per-batch mods [B,D] on
    [B,L,D], axis=0 for per-position mods [K,D] on [B,K,D]."""
    if shift is None and scale is None:
        return x
    if scale is not None and scale.ndim == x.ndim:
        sh = torch.zeros_like(scale) if shift is None else shift
        return x * (1 + scale) + sh
    s = 0 if scale is None else scale.unsqueeze(axis)
    sh = 0 if shift is None else shift.unsqueeze(axis)
    return x * (1 + s) + sh


def gate(x, g, axis=0):
    """Gated residual branch."""
    if g is None:
        return x
    return g.unsqueeze(axis) * x


def timestep_embedder(t, w0, b0, w2, b2, dim_freq=256):
    """TimestepEmbedder: sinusoid -> Linear -> SiLU -> Linear."""
    h = timestep_embedding(t, dim_freq)
    h = linear(h, w0, b0)
    return linear(F.silu(h), w2, b2)
