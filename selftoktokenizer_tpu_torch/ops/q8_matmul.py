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
shapes the two are within 10-30 % of each other, below the card's ridge
point, which is why int8 weights (half the bytes of bf16) can pay on this
card where the TPU found no gain. The CUDA side (``csrc/q8_matmul.cu``) is
two kernels on one stream, launched by one C call: a row pass quantizes x
once per linear into int8 ``xq [M, Kp]`` and ``sx [M]``, then a TMA-fed
``wgmma`` s8 GEMM with split-K makes the product and the epilogue. The tile
width and the K splits come from ``plan_q8``, a pure function of the shape
that the CPU tests reach. Every float step is explicitly rounded, so the
kernel equals the plain version bit for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from selftoktokenizer_tpu_torch.ops import _build

# products launched on the card (one per q8_matmul call: its quantize pass
# and its GEMM) since the last reset
launch_count = 0
# launches of the quantize pass alone (q8_quantize_rows), never on a path
quantize_launch_count = 0

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


def padded_k(K):
    """K rounded up to 16: the row length of the quantized x (and of a
    weight the GEMM reads), so that each row is a TMA stride (16-byte
    multiple)."""
    return -(-K // 16) * 16


def q8_quantize_rows_plain(x):
    """Plain version of the quantize pass: x [M, K] -> (xq [M, padded_k(K)]
    int8, zero past K; sx [M] fp32), the first half of ``q8_matmul_plain``."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True) * INV127, 1e-8)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return F.pad(xq, (0, padded_k(x.shape[1]) - x.shape[1])), sx[:, 0]


def q8_matmul_quantized_plain(xq, sx, wq, sw, bias=None, dtype=torch.bfloat16):
    """Plain version of the GEMM and its epilogue on quantized operands: xq
    [M, Kp] int8 and sx [M] (``q8_quantize_rows_plain``'s), wq [N, K] -> [M,
    N] of ``dtype``, the second half of ``q8_matmul_plain``."""
    p = (xq[:, :wq.shape[1]].double() @ wq.double().t()).float() * sx[:, None]
    sw = sw.float()
    if bias is None:
        return (p * sw).to(dtype)
    b = bias.to(dtype)
    if dtype == torch.float32:
        return (p.double() * sw.double() + b.double()).float()
    return ((p * sw).to(dtype).float() + b.float()).to(dtype)


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


# ---------------------------------------------------------------- planner ---
# The GEMM's tiles are BM x bn (bn one of BNS), its K tiles BK bytes deep.
# plan_q8 picks bn and the number of K splits for a shape by a cost model of
# the H100: blocks run in waves of one per SM (a block takes most of the
# shared memory), each streams its K tiles and its partial tile from L2 at
# one SM's rate and pays a fixed cost (more with split-K), and all blocks
# together share the L2's rate. The four constants are effective values,
# fitted to every plan's time at the decode's and the renderer's shapes
# (``chip_smoke.py --q8-sweep`` on an H100; PERF.md): with them the planner
# picks the fastest measured plan at each of those thirteen shapes.
SMS = 132                      # streaming multiprocessors of an H100 SXM
BM, BK = 128, 128
BNS = (64, 96, 128, 144, 192)   # widths that cut the decode's N = 1536, 4608, 6144 into whole waves
STAGES = 4
THREADS = 288                  # two consumer warpgroups and one producer warp
MAX_SPLITS = 16
SMEM_LIMIT = 232448            # bytes of shared memory a block can have
GRID_YZ_LIMIT = 65535
SM_BYTES_PER_S = 50e9          # one SM's rate from L2
L2_BYTES_PER_S = 6e12          # all SMs together from L2
BLOCK_S = 2e-6                 # a block's fixed cost: barriers, pipeline fill, epilogue
SPLIT_S = 4e-6                 # and with split-K: the arrival count, the last split's wait


def _cdiv(a, b):
    return -(-a // b)


def _align(n, a=256):
    return _cdiv(n, a) * a


def smem_bytes(bn):
    """Dynamic shared memory of a GEMM block (csrc/q8_matmul.cu::smem_bytes)."""
    return 1024 + STAGES * (BM + bn) * BK + 2 * STAGES * 8 + 2 * bn * 4 + 16


@dataclasses.dataclass(frozen=True)
class Q8Plan:
    """How one product [M, K] x [K, N] is cut: 128 x ``bn`` output tiles,
    ``k_tiles`` K tiles of 128 over ``Kp``, ``splits`` K splits; and the
    layout of its one scratch buffer (xq, sx, split-K counters, partials).
    The derived values are computed once: ``plan_q8`` hands out one plan per
    shape, and the wrapper reads them at every call."""
    M: int
    K: int
    N: int
    bn: int
    splits: int

    @functools.cached_property
    def Kp(self):
        return padded_k(self.K)

    @functools.cached_property
    def k_tiles(self):
        return _cdiv(self.Kp, BK)

    @functools.cached_property
    def tiles_m(self):
        return _cdiv(self.M, BM)

    @functools.cached_property
    def tiles_n(self):
        return _cdiv(self.N, self.bn)

    @functools.cached_property
    def grid(self):
        return (self.tiles_m, self.tiles_n, self.splits)

    def k_range(self, split):
        """K tiles [start, stop) of one split: the first k_tiles % splits
        splits take one more (the kernel's formula)."""
        per, rem = divmod(self.k_tiles, self.splits)
        start = split * per + min(split, rem)
        return start, start + per + (split < rem)

    @functools.cached_property
    def n_counters(self):
        return self.tiles_m * self.tiles_n if self.splits > 1 else 0

    @functools.cached_property
    def partial_bytes(self):
        return self.splits * self.n_counters * BM * self.bn * 4

    # scratch layout, each part 256-byte aligned
    @functools.cached_property
    def sx_offset(self):
        return _align(self.M * self.Kp)

    @functools.cached_property
    def counters_offset(self):
        return self.sx_offset + _align(4 * self.M)

    @functools.cached_property
    def partials_offset(self):
        return self.counters_offset + _align(4 * self.n_counters)

    @functools.cached_property
    def scratch_bytes(self):
        return self.partials_offset + self.partial_bytes


def _plan_seconds(M, N, k_tiles, bn, splits, out_item):
    tiles = _cdiv(M, BM) * _cdiv(N, bn)
    blocks = tiles * splits
    partial = BM * bn * 4 * splits if splits > 1 else 0   # written, and the last split's reads
    block_bytes = _cdiv(k_tiles, splits) * (BM + bn) * BK + partial + BM * bn * out_item
    block_s = BLOCK_S + (SPLIT_S if splits > 1 else 0)
    per_sm = _cdiv(blocks, SMS) * (block_bytes / SM_BYTES_PER_S + block_s)
    return max(per_sm, blocks * block_bytes / L2_BYTES_PER_S)


@functools.lru_cache(maxsize=4096)
def plan_q8(M, K, N, out_item=2):
    """The GEMM's tile width and K splits for x [M, K] times wq [N, K]
    (``out_item``: bytes of an output value), the least modelled time, ties
    to fewer splits and then the wider tile. Raises if the grid exceeds
    the card's limits."""
    if M < 1 or K < 1 or N < 1:
        raise ValueError(f"q8_matmul: empty product {M}x{K}x{N}")
    k_tiles = _cdiv(padded_k(K), BK)
    best = None
    for bn in BNS:
        if _cdiv(N, bn) > GRID_YZ_LIMIT:
            continue
        for splits in range(1, min(k_tiles, MAX_SPLITS) + 1):
            key = (_plan_seconds(M, N, k_tiles, bn, splits, out_item), splits, -bn)
            if best is None or key < best[0]:
                best = (key, Q8Plan(M, K, N, bn, splits))
    if best is None or best[1].tiles_m >= 2 ** 31:
        raise ValueError(f"q8_matmul: {M}x{K}x{N} exceeds the kernel's grid")
    return best[1]


def _lib():
    lib = _build.load("q8_matmul")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_q8_matmul.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.stk_q8_matmul.restype = ctypes.c_int
        lib.stk_q8_quantize_rows.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.stk_q8_quantize_rows.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


def _check_rc(rc, what):
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError(f"q8_matmul: the {what} refused its arguments")
    if rc == -2:
        raise RuntimeError("q8_matmul: cuTensorMapEncodeTiled not found in libcuda")
    if rc <= -1000:
        raise RuntimeError(f"q8_matmul: cuTensorMapEncodeTiled failed (CUresult {-1000 - rc})")
    raise RuntimeError(f"q8_matmul: {what} launch failed (cudaError {rc})")


def q8_quantize_rows(x):
    """The quantize pass alone: x [M, K] bf16 or fp32 -> (xq [M, padded_k(K)]
    int8, sx [M] fp32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises. ``q8_matmul`` runs this kernel itself;
    this entry serves to check and time it."""
    if x.ndim != 2 or x.dtype not in _DTYPES or x.shape[1] == 0:
        raise ValueError(f"q8_quantize_rows: bad input {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return q8_quantize_rows_plain(x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError("q8_quantize_rows: the kernel takes a contiguous CUDA tensor")
    M, K = x.shape
    xq = torch.empty((M, padded_k(K)), dtype=torch.int8, device=x.device)
    sx = torch.empty((M,), dtype=torch.float32, device=x.device)
    if M == 0:
        return xq, sx
    global quantize_launch_count
    with torch.cuda.device(x.device):
        rc = _lib().stk_q8_quantize_rows(x.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K,
                                         padded_k(K), _DTYPES[x.dtype],
                                         torch.cuda.current_stream().cuda_stream)
    quantize_launch_count += 1
    _check_rc(rc, "quantize kernel")
    return xq, sx


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
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    return _launch(x, wq, sw, bias, out, plan_q8(M, K, N, x.element_size()))


def _launch(x, wq, sw, bias, out, plan):
    """One product on the card by ``plan``: the quantize pass and the GEMM,
    one C call, one count."""
    M, K = x.shape
    N = wq.shape[0]
    if plan.Kp != K or wq.data_ptr() % 16:
        # TMA reads rows of a 16-byte multiple: a weight whose K is not one
        # (none on the decode's path, where K is 1536, 6144 or 16) is padded
        # with zero columns, per call
        wq = F.pad(wq, (0, plan.Kp - K)).contiguous()
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return _launch(x, wq, sw, bias, out, plan)
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=x.device)
    base = scratch.data_ptr()
    split = plan.splits > 1
    global launch_count
    rc = _lib().stk_q8_matmul(
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(),
        base, base + plan.sx_offset,
        base + plan.counters_offset if split else None,
        base + plan.partials_offset if split else None,
        M, K, N, plan.Kp, plan.bn, plan.splits,
        _DTYPES[x.dtype], 0 if bias is None else _DTYPES[bias.dtype],
        torch.cuda.current_stream().cuda_stream)
    launch_count += 1
    _check_rc(rc, "kernel")
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
