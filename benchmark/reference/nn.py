"""Plain building blocks of the reference.

The reference computes each part in the type the configuration states for
it: fp32 with TF32 off (``exact_fp32``) for the encoder, the VAE's and the
decoder's own types (bf16 in the flagship cells) for them. Every function
computes in the type of its input, with norm statistics and softmax in fp32
and products accumulated in fp32. Feature maps are NHWC, linear weights are
``[out, in]`` and convolution kernels ``OIHW``, the layouts of the state
dicts the benchmark hands to both sides.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6          # every LayerNorm and GroupNorm of the model


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for CUDA matmuls and cuDNN convolutions; restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def linear(x, sd, name, bias=True):
    b = sd[name + ".bias"].to(x.dtype) if bias else None
    return F.linear(x, sd[name + ".weight"].to(x.dtype), b)


def layer_norm(x, weight=None, bias=None):
    """Statistics in fp32; the normalised row in x's type, then the affine
    in that type."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + EPS)).to(x.dtype)
    if weight is not None:
        y = y * weight.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def group_norm(x, weight, bias, groups=32):
    """NHWC GroupNorm: statistics in fp32 per (sample, group) over H, W and
    the group's channels; the normalised map in x's type, then the affine
    in that type."""
    b, h, w, c = x.shape
    g = x.float().reshape(b, h, w, groups, c // groups)
    mean = g.mean(dim=(1, 2, 4), keepdim=True)
    var = ((g - mean) ** 2).mean(dim=(1, 2, 4), keepdim=True)
    y = ((g - mean) * torch.rsqrt(var + EPS)).reshape(b, h, w, c).to(x.dtype)
    return y * weight.to(x.dtype) + bias.to(x.dtype)


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def conv2d(x, sd, name, stride=1, padding=None):
    """NHWC convolution in x's type; ``padding`` None pads a k x k kernel
    by k // 2."""
    w = sd[name + ".weight"]
    pad = w.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), sd[name + ".bias"].to(x.dtype),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def timestep_embedding(t, dim=256, max_period=10000):
    """[cos | sin] of t times log-spaced frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def timestep_mlp(sd, name, t, dim=256):
    """Sinusoid -> Linear -> SiLU -> Linear."""
    h = linear(timestep_embedding(t, dim), sd, name + ".mlp.0")
    return linear(F.silu(h), sd, name + ".mlp.2")


def sincos_1d(dim, pos):
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.einsum("m,d->md", np.asarray(pos, np.float64).reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim, grid):
    g = np.arange(grid, dtype=np.float32)
    ww, hh = np.meshgrid(g, g)
    return np.concatenate([sincos_1d(dim // 2, ww), sincos_1d(dim // 2, hh)], axis=1)


def attention(q, k, v, key_mask=None, fp32_scores=False):
    """Softmax attention of q [B, H, Lq, D] over k, v [B, H, Lk, D]: the
    scores in q's type (or, with ``fp32_scores``, the products of q's and
    k's values accumulated in fp32), the softmax in fp32, its weights cast
    to v's type for the second product; a masked key (key_mask [B, Lk]
    False) gets the bias -1e30."""
    if fp32_scores:
        q, k = q.float(), k.float()
    s = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(q.shape[-1]))
    if key_mask is not None:
        s = s + torch.where(key_mask, 0.0, -1e30)[:, None, None, :]
    return torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)


def attention_online(q, k, v, key_mask=None, tile=64):
    """Softmax attention in the online form over tiles of ``tile`` keys, for
    bf16 operands: the scores' products accumulated in fp32 and scaled into
    the log2 domain, a running row max, each tile's exponentials (relative
    to that max) cast to bf16 for the second product, which accumulates in
    fp32 and is rescaled as the max grows, and the rows' sums of the unrounded
    exponentials; the output divided by the sum and cast to v's type. A
    masked key (key_mask [B, Lk] False) gets the bias -1e30 (in the log2
    domain)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (math.log2(math.e)
                                                               / math.sqrt(q.shape[-1]))
    if key_mask is not None:
        s = s + torch.where(key_mask, 0.0, -1e30)[:, None, None, :]
    m = torch.full(s.shape[:-1] + (1,), -math.inf, device=s.device)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=s.device)
    for j in range(0, s.shape[-1], tile):
        x = s[..., j:j + tile]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(v.dtype).float(), v[..., j:j + tile, :].float())
        m = m_new
    return (o * (1.0 / l)).to(v.dtype)


def heads(t, n):
    """[B, L, n * d] -> [B, n, L, d]."""
    b, l, c = t.shape
    return t.reshape(b, l, n, c // n).permute(0, 2, 1, 3)


def merge(t):
    b, n, l, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, l, n * d)


def modulate(x, shift, scale):
    return x * (1 + scale) + shift


def patchify(x, sd, name, patch):
    """A patch x patch, stride-patch convolution as one product:
    NHWC [B, H, W, C] -> [B, (H / patch) * (W / patch), D]."""
    w = sd[name + ".weight"]
    b, h, wd, c = x.shape
    gh, gw = h // patch, wd // patch
    cols = x.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    cols = cols.reshape(b, gh * gw, patch * patch * c)
    return F.linear(cols, w.permute(0, 2, 3, 1).reshape(w.shape[0], -1).to(x.dtype),
                    sd[name + ".bias"].to(x.dtype))


def center_crop(table, max_size, gh, gw):
    """(1, max_size^2, C) table -> (1, gh * gw, C), centred."""
    c = table.shape[-1]
    top, left = (max_size - gh) // 2, (max_size - gw) // 2
    grid = table.reshape(1, max_size, max_size, c)
    return grid[:, top:top + gh, left:left + gw].reshape(1, gh * gw, c)
