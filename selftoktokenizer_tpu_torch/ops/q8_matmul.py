"""W8A8 int8 matrix product of the int8 decode: CUDA kernel, its plain
PyTorch version and the launch counter, with the weight side around it
(``quantize_weight``, ``Q8Linear``, ``quantize_model_``, ``q8_linear``).

Replaces the TPU kernel ``selftoktokenizer_tpu/ops/q8_matmul.py::q8_matmul``
(Pallas) and the functions beside it. Weights are quantized once, per output
channel, symmetric: ``s_w = max(max_in |w| / 127, 1e-8)``,
``w_q = clip(round(w / s_w), +-127)``. Activations are quantized per row
inside the kernel from the row's max, the product is exact in int32, and the
result is dequantized by ``s_x * s_w`` and rounded to x's type; the bias is
then added in x's type, as the reference's ``q8_linear`` adds it. In fp32
the last product and the bias are one fused multiply-add, because XLA
contracts them so in the reference's compiled ``q8_linear``.

The activation scale is ``max|x| * fp32(1/127)``, a product and not a
division: XLA rewrites the reference's ``max|x| / 127.0`` into that product
in every compiled program (the Pallas kernel and the jitted decode alike),
and the port equals those bit for bit. Only the reference's op-by-op
(un-jitted) emulation divides, and differs from them by one ulp of the scale
in a few rows.

Bound on an H100: 2*M*K*N int8 tensor-core operations (1,979 TOP/s) against
M*K*itemsize + K*N + 6*N + M*N*itemsize bytes (3.35 TB/s); at the decode's
shapes the two are within 10 % of each other, below the card's ridge point,
which is why int8 weights (half the bytes of bf16) can pay on this card
where the TPU found no gain. The kernel (``csrc/q8_matmul.cu``) reads its
rows of x once for the scales and quantizes each K tile on its way into
shared memory; every float step is explicitly rounded, so it equals the
plain version bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

# linear modules eligible for int8 serving quantization (the reference's
# _QUANT_KEYS): the decode's joint-block attention and MLP projections, the
# context embedder and the final layer's linear
QUANT_KEYS = ("qkv", "proj", "fc1", "fc2", "context_embedder", "linear")
MIN_SIZE = 2 ** 12

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
INV127 = float(np.float32(1.0) / np.float32(127.0))   # XLA's fp32 reciprocal of 127


def quantize_weight(w):
    """[..., out, in] float -> (int8 [..., out, in], fp32 scales [..., out]),
    per output channel (reducing over ``in``), in fp32 as the reference's
    numpy quantizer."""
    w = w.float()
    s = torch.clamp_min(w.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(w / s.unsqueeze(-1)), -127, 127).to(torch.int8)
    return q, s


def q8_matmul_plain(x, wq, sw, bias=None):
    """Plain version, the kernel's arithmetic written out: per-row scale
    (times the fp32 reciprocal of 127), IEEE division, round half to even,
    clip, an exact integer product (in float64, exact because
    |sum| <= 6144 * 127^2 < 2^53, and available on every device where an
    int8 matmul is not), one rounding to fp32, dequantize, round to x's
    type, bias added in x's type. The fp32 fused multiply-add is taken in
    float64, where the product is exact; its one rounding there differs from
    the kernel's only if the float64 sum lands on an fp32 tie (about one
    value in 2^28)."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True) * INV127, 1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127)
    p = (xq.double() @ wq.double().t()).float() * sx
    sw = sw.float()
    if bias is None:
        return (p * sw).to(x.dtype)
    b = bias.to(x.dtype)
    if x.dtype == torch.float32:
        return (p.double() * sw.double() + b.double()).float()
    return ((p * sw).to(x.dtype).float() + b.float()).to(x.dtype)


def _lib():
    lib = _build.load("q8_matmul")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_q8_matmul.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.stk_q8_matmul.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


def q8_matmul(x, wq, sw, bias=None):
    """x: [M, K] bf16 or fp32; wq: [N, K] int8 (torch's [out, in]); sw: [N]
    fp32; bias: optional [N] bf16 or fp32 -> [M, N] of x's type.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if x.ndim != 2 or wq.ndim != 2 or x.shape[1] != wq.shape[1] \
            or tuple(sw.shape) != (wq.shape[0],) \
            or (bias is not None and tuple(bias.shape) != (wq.shape[0],)):
        raise ValueError(f"q8_matmul: bad shapes {tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(sw.shape)}, {None if bias is None else tuple(bias.shape)}")
    if wq.dtype != torch.int8 or sw.dtype != torch.float32:
        raise ValueError("q8_matmul: wq must be int8 and sw fp32")
    if x.dtype not in _DTYPES or (bias is not None and bias.dtype not in _DTYPES):
        raise ValueError("q8_matmul: x and the bias must be bf16 or fp32")
    devices = {x.device, wq.device, sw.device} | ({bias.device} if bias is not None else set())
    if len(devices) != 1:
        raise ValueError("q8_matmul: inputs lie on different devices")
    M, K = x.shape
    N = wq.shape[0]
    if K == 0:
        raise ValueError("q8_matmul: K must be positive")
    if x.device.type == "cpu":
        return q8_matmul_plain(x, wq, sw, bias)
    if x.device.type != "cuda":
        raise ValueError(f"q8_matmul: unsupported device {x.device}")
    if not (x.is_contiguous() and wq.is_contiguous() and sw.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("q8_matmul: the kernel takes contiguous inputs")
    if M > 65535 * 64:
        raise ValueError(f"q8_matmul: M={M} exceeds the kernel's grid")
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    global launch_count
    with torch.cuda.device(x.device):
        rc = _lib().stk_q8_matmul(
            x.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            M, K, N, _DTYPES[x.dtype], 0 if bias is None else _DTYPES[bias.dtype],
            torch.cuda.current_stream().cuda_stream)
    launch_count += 1
    if rc != 0:
        raise RuntimeError(f"q8_matmul: kernel launch failed (cudaError {rc})")
    return out


class Q8Linear(nn.Module):
    """An ``nn.Linear`` quantized for the int8 decode: int8 ``weight_q``
    [out, in], fp32 per-output scales ``s_w`` [out] and the bias in the
    decode dtype. No float copy of the weight is kept."""

    def __init__(self, weight_q, s_w, bias=None):
        super().__init__()
        self.register_buffer("weight_q", weight_q)
        self.register_buffer("s_w", s_w.float())
        self.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)

    @classmethod
    def from_linear(cls, lin: nn.Linear):
        q, s = quantize_weight(lin.weight.detach())
        return cls(q, s, None if lin.bias is None else lin.bias.detach().clone())

    def _apply(self, fn, recurse=True):
        # module.to(dtype) casts every floating tensor; the scales must stay
        # fp32 (the reference's decode cast leaves s_w alone), so they go
        # through as their int32 bits, which a cast of dtype leaves as they
        # are and a move of device carries along
        s_w = self._buffers.pop("s_w")
        super()._apply(fn, recurse)
        self.register_buffer("s_w", fn(s_w.view(torch.int32)).view(torch.float32))
        return self

    def extra_repr(self):
        return f"in_features={self.weight_q.shape[1]}, out_features={self.weight_q.shape[0]}"


def q8_linear(m: Q8Linear, x, plain=False):
    """Q8Linear applied to x [..., in] (counterpart of the reference's
    ``q8_linear``) -> [..., out] of x's type; plain=True takes the kernel's
    plain version."""
    shape = x.shape
    xf = x.reshape(-1, shape[-1]).contiguous()
    y = (q8_matmul_plain if plain else q8_matmul)(xf, m.weight_q, m.s_w, m.bias)
    return y.reshape(*shape[:-1], y.shape[-1])


@torch.no_grad()
def quantize_model_(model: nn.Module, min_size=MIN_SIZE):
    """Swap the eligible ``nn.Linear`` modules of an MMDiT for ``Q8Linear``,
    in place (counterpart of the reference's ``quantize_params_tree``).

    Eligible: the attribute name is in ``QUANT_KEYS`` and the weight, as
    the reference's parameter tree holds it, has at least ``min_size``
    elements. That tree stacks joint blocks 0..depth-2 into one
    [depth-1, in, out] leaf, so their linears are judged by (depth-1) times
    their size; the last block and the top-level linears by their own.
    Quantize after the cast to bf16, as the reference does, so the int8
    weights and scales are those of the bf16-rounded weights."""
    depth = len(model.joint_blocks)
    swaps = []
    for name, mod in model.named_modules():
        parent, _, attr = name.rpartition(".")
        if not isinstance(mod, nn.Linear) or attr not in QUANT_KEYS:
            continue
        parts = name.split(".")
        stacked = parts[0] == "joint_blocks" and int(parts[1]) < depth - 1
        if mod.weight.numel() * (depth - 1 if stacked else 1) >= min_size:
            swaps.append((parent, attr, mod))
    for parent, attr, mod in swaps:
        setattr(model.get_submodule(parent) if parent else model, attr,
                Q8Linear.from_linear(mod))
    return model
