"""Fused softmax attention with an optional per-key mask: CUDA kernels
(forward and backward), their plain PyTorch versions and the launch counters.

Replaces the TPU kernel
``selftoktokenizer_tpu/ops/flash_attention.py::_flash_mha`` (Pallas), entered
through ``flash_sdpa_key_mask``: softmax(q k^T / sqrt(D) + bias) v per
(batch, head), where a per-key mask [B, Lk] (True = attend) becomes a finite
-1e30 bias broadcast over heads and queries; softmax in fp32, weights cast
to ``v.dtype`` before P V. Any Lq and Lk are accepted: the ragged tiles are
masked in the kernels. q, k and v may be strided views (the qkv split's);
the output is allocated in [B, Lq, H, D] memory and returned as a
[B, H, Lq, D] view, so merging the heads after it is free.

Forward. bf16: ``csrc/flash_attention.cu``, a TMA-fed ring of K/V tiles, an
online softmax, both products on ``wgmma`` with one tile's exponentials
overlapped with the previous tile's P V. fp32:
``csrc/flash_attention_tf32.cu``, the same ring and online softmax with both
products in split TF32 on ``mma.sync`` (x = hi + lo in TF32, hi*hi + hi*lo
+ lo*hi summed in fp32: the counterpart of the TPU kernel's products at
``precision=HIGHEST``; each k8 step of S and each key tile's P V in a fresh
accumulator, as the tensor core truncates what it adds to a large one).
Bound on an H100: 4*B*H*Lq*Lk*D FLOP (bf16 tensor cores, 989 TFLOP/s; split
TF32 three passes at 495) against
(2*Lq + 2*Lk)*D*B*H*itemsize bytes at 3.35 TB/s, and B*H*Lq*Lk exponentials
(16 a clock on each SM's special-function units).

Gradients: ``flash_sdpa_key_mask`` is a ``torch.autograd.Function``. When a
gradient will be needed its forward also writes each row's max m (log2
domain: x = s * scale * log2(e) + bias) and sum l, fp32 [2, B, H, Lq]; its
backward is the reference's ``_make_flash_vjp`` backward in a kernel of its
own (``csrc/flash_attention_tf32.cu``, split TF32, bf16 and fp32): P =
exp2(x - m) / l, dV = P^T dO, dP = dO V^T, dS = P * (dP - Delta) with
Delta = rowsum(dO * O), dQ = dS K * scale, dK = dS^T Q * scale, each cast
to its input's type, the mask without a gradient; one pass over the key
tiles for dQ, one over the query tiles for dK and dV, no [Lq, Lk] tensor in
device memory and no atomics. ``backward_launch_count`` counts its calls.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import numpy as np
import torch

from selftoktokenizer_tpu_torch.ops import _build

# launches of the forward kernels (and nothing else) since the last reset,
# and of the fp32 one among them
launch_count = 0
fp32_launch_count = 0
# launches of the backward kernels (one per backward call: the dQ pass, then
# the dK / dV pass) since the last reset
backward_launch_count = 0

NEG = -1e30
LOG2E = 1.4426950408889634
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# the bf16 kernel's launch (csrc/flash_attention.cu): a block of one consumer
# warpgroup and a producer warp per BM query rows of a (batch, head), K/V
# tiles of BN keys through a ring of STAGES[D]
SMEM_LIMIT = 232448            # bytes of shared memory a block can have
GRID_Y_LIMIT = 65535
BM = 64
BN = 64
STAGES = {64: 4, 128: 2}


def smem_bytes(D):
    """The bf16 kernel's dynamic shared memory at head dim D (Tile<D>::SMEM):
    alignment slack, Q, the ring, each stage's key bias, the barriers, each
    stage's flag."""
    sub, st = D // 64, STAGES[D]
    return 1024 + sub * BM * 128 + st * 2 * sub * BN * 128 + st * BN * 4 + (1 + 2 * st) * 8 + st * 4


# the split-TF32 kernels' launch (csrc/flash_attention_tf32.cu): a block of
# four consumer warps and a producer warp per 64 rows of its own, 64-row
# tiles of the other side through a ring of TF32_STAGES
TF32_STAGES = 2
TF32_KERNELS = {
    # name: (own 64-row tiles, floats of side data a stage, input types)
    "forward": (1, 64, (torch.float32,)),
    "dq": (2, 64, (torch.bfloat16, torch.float32)),
    "dkdv": (2, 3 * 64, (torch.bfloat16, torch.float32)),
}


def tf32_smem_bytes(kernel, D, dtype):
    """A split-TF32 kernel's dynamic shared memory (Smem<T, D, OWN, SIDE>
    in the source): alignment slack, its own tiles, the ring, each stage's
    side data (key bias, or the query rows' m, 1 / l and Delta), the
    barriers."""
    own, side, _ = TF32_KERNELS[kernel]
    tile = 64 * D * (2 if dtype == torch.bfloat16 else 4)
    return 1024 + own * tile + TF32_STAGES * 2 * tile + TF32_STAGES * side * 4 \
        + (1 + 2 * TF32_STAGES) * 8


def supported(q, k):
    """Whether the kernel takes these shapes and types (on any device)."""
    return (q.ndim == 4 and q.shape[-1] in HEAD_DIMS and q.dtype in _DTYPES
            and k.shape[2] > 0 and q.shape[2] > 0)


def flash_sdpa_key_mask_plain(q, k, v, key_mask=None, stats=False):
    """Plain version, the kernels' arithmetic written out: products of the
    input type accumulated in fp32, the finite -1e30 key bias, fp32 softmax,
    weights cast to v.dtype before the second product. stats=True also
    returns the rows' statistics in the kernels' convention, fp32
    [2, B, H, Lq]: m = max of x = s * scale * log2(e) + bias, and
    l = sum of exp2(x - m)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG).to(torch.float32)
        s = s + bias[:, None, None, :]
    w = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.matmul(w.float(), v.float()).to(q.dtype)
    if not stats:
        return out
    x = _log2_scores(q, k, key_mask)
    m = x.amax(dim=-1)
    return out, torch.stack([m, torch.exp2(x - m[..., None]).sum(dim=-1)])


def _log2_scores(q, k, key_mask):
    """x = s * scale * log2(e) + bias in fp32, [B, H, Lq, Lk]."""
    x = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (LOG2E / math.sqrt(q.shape[-1]))
    if key_mask is not None:
        x = x + torch.where(key_mask, 0.0, NEG).to(torch.float32)[:, None, None, :]
    return x


def flash_sdpa_key_mask_backward_plain(q, k, v, key_mask, o, do, stats):
    """Plain version of the backward kernel, on its inputs: the forward's
    output o and row statistics ([2, B, H, Lq]: m, l), its gradient do. P is
    rebuilt from the statistics, Delta = rowsum(do * o); returns (dq, dk, dv)
    in the inputs' types."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    x = _log2_scores(q, k, key_mask)
    p = torch.exp2(x - stats[0][..., None]) / stats[1][..., None]
    del x
    dof = do.float()
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = dp.sub_(delta).mul_(p)
    del p
    dq = torch.matmul(ds, k.float()).mul_(scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()).mul_(scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib(name="flash_attention"):
    """The bf16 forward's library, or (name "flash_attention_tf32") the fp32
    forward's and the backward's."""
    lib = _build.load(name)
    if not getattr(lib, "_stk_typed", False):
        fwd = (lib.stk_flash_attention if name == "flash_attention"
               else lib.stk_flash_attention_f32)
        fwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 13
                        + [ctypes.c_void_p] * 3)
        fwd.restype = ctypes.c_int
        if name != "flash_attention":
            lib.stk_flash_attention_backward.argtypes = (
                [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_longlong,
                                                                ctypes.c_void_p])
            lib.stk_flash_attention_backward.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


def _strides(name, shape, stride, item):
    """(batch, head, row) strides in elements of a [B,H,L,D] tensor whose
    last dimension is dense; rows must start on 16-byte boundaries. A
    dimension of size 1 is never stepped along: its stride is replaced by
    one the tensor maps accept."""
    if stride[3] != 1:
        raise ValueError(f"flash_sdpa_key_mask: {name} must be dense in its last dimension")
    size1 = shape[3] * shape[2] * shape[1]
    strides = tuple(st if n > 1 else size1 for st, n in zip(stride[:3], shape[:3]))
    if any((st * item) % 16 for st in strides):
        raise ValueError(f"flash_sdpa_key_mask: {name} rows must be 16-byte aligned")
    return strides


@functools.lru_cache(maxsize=4096)
def _call_args(q_shape, k_shape, q_stride, k_stride, v_stride, item, dtype_code):
    """The C call's sizes and strides for one layout, checked once."""
    B, H, Lq, D = q_shape
    Lk = k_shape[2]
    o_shape = (B, H, Lq, D)
    o_stride = (Lq * H * D, D, H * D, 1)        # [B, Lq, H, D] memory
    return (B, H, Lq, Lk, D, dtype_code,
            *_strides("q", q_shape, q_stride, item), *_strides("k", k_shape, k_stride, item),
            *_strides("v", k_shape, v_stride, item), *_strides("out", o_shape, o_stride, item),
            Lk)


def _check_rc(rc):
    if rc == 0:
        return
    if rc == -1:
        raise RuntimeError("flash_sdpa_key_mask: the kernel refused its arguments")
    if rc == -2:
        raise RuntimeError("flash_sdpa_key_mask: cuTensorMapEncodeTiled not found in libcuda")
    if rc <= -1000:
        raise RuntimeError(f"flash_sdpa_key_mask: cuTensorMapEncodeTiled failed (CUresult {-1000 - rc})")
    raise RuntimeError(f"flash_sdpa_key_mask: kernel launch failed (cudaError {rc})")


def flash_sdpa_key_mask(q, k, v, key_mask=None):
    """q: [B,H,Lq,D]; k, v: [B,H,Lk,D]; D in {64, 128}; bf16 or fp32;
    key_mask: optional bool [B, Lk], True = attend. -> [B,H,Lq,D] (a view of
    [B,Lq,H,D] memory on the card).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if q.ndim != 4 or k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(
            f"flash_sdpa_key_mask: bad shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if key_mask is not None and (key_mask.dtype != torch.bool
                                 or tuple(key_mask.shape) != (B, Lk)):
        raise ValueError("flash_sdpa_key_mask: key_mask must be bool [B, Lk]")
    if not (q.device == k.device == v.device) or \
            (key_mask is not None and key_mask.device != q.device):
        raise ValueError("flash_sdpa_key_mask: inputs lie on different devices")
    if q.device.type == "cuda":
        if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
            raise ValueError("flash_sdpa_key_mask: the kernel takes bf16 or fp32, one type for q, k, v")
        if D not in HEAD_DIMS:
            raise ValueError(f"flash_sdpa_key_mask: the kernel takes head dim 64 or 128, got {D}")
        if Lq == 0 or Lk == 0 or B * H == 0 or B * H > GRID_Y_LIMIT:
            raise ValueError(f"flash_sdpa_key_mask: unsupported sizes B*H={B * H}, Lq={Lq}, Lk={Lk}")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_sdpa_key_mask: unsupported device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashSdpaKeyMask.apply(q, k, v, key_mask)
    return _forward(q, k, v, key_mask)


def _forward(q, k, v, key_mask, stats=False):
    """The kernel on a CUDA tensor, the plain version on a CPU one; with
    stats, (out, [2, B, H, Lq] row statistics)."""
    if q.device.type == "cpu":
        return flash_sdpa_key_mask_plain(q, k, v, key_mask, stats=stats)
    return _launch(q, k, v, key_mask, stats=stats)


def flash_sdpa_key_mask_backward(q, k, v, key_mask, o, do, stats):
    """(dq, dk, dv) of the attention at (q, k, v, key_mask) for the output
    gradient do, from the forward's output o and row statistics
    ([2, B, H, Lq]). A CUDA tensor launches the backward kernels or raises;
    a CPU tensor takes the plain version."""
    if q.device.type == "cpu":
        return flash_sdpa_key_mask_backward_plain(q, k, v, key_mask, o, do, stats)
    return _launch_backward(q, k, v, key_mask, o, do, stats)


class _FlashSdpaKeyMask(torch.autograd.Function):
    """The kernel forward on detached inputs, with the rows' statistics;
    the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        out, stats = _forward(q.detach(), k.detach(), v.detach(), key_mask, stats=True)
        ctx.save_for_backward(q, k, v, key_mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, out, stats = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_key_mask_backward(q, k, v, key_mask, out, do, stats)
        return dq, dk, dv, None


def _heads_last(B, H, L, D, dtype, device):
    """A [B, H, L, D] tensor in [B, L, H, D] memory."""
    return torch.empty_strided((B, H, L, D), (L * H * D, D, H * D, 1), dtype=dtype, device=device)


def _on_device(t):
    """Run under t's device when it is not the current one."""
    dev = t.get_device()
    return torch.cuda.device(dev) if dev != torch.cuda.current_device() else contextlib.nullcontext()


def _launch(q, k, v, key_mask, stats=False):
    """One forward launch on the card: the bf16 kernel or the fp32 one."""
    with _on_device(q):
        B, H, Lq, D = q.shape
        args = _call_args(q.shape, k.shape, q.stride(), k.stride(), v.stride(), q.element_size(),
                          _DTYPES[q.dtype])
        # [B, Lq, H, D] memory: merging the heads afterwards is a free reshape
        out = _heads_last(B, H, Lq, D, q.dtype, q.device)
        st = torch.empty((2, B, H, Lq), dtype=torch.float32, device=q.device) if stats else None
        if key_mask is not None:
            key_mask = key_mask.contiguous()
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
        if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
            raise ValueError("flash_sdpa_key_mask: q, k and v must start on 16-byte boundaries")
        if q.dtype == torch.bfloat16:
            fn = _lib().stk_flash_attention
        else:
            fn = _lib("flash_attention_tf32").stk_flash_attention_f32
        global launch_count, fp32_launch_count
        rc = fn(*ptrs, out.data_ptr(), None if key_mask is None else key_mask.data_ptr(), *args,
                None if st is None else st[0].data_ptr(), None if st is None else st[1].data_ptr(),
                torch._C._cuda_getCurrentRawStream(q.get_device()))
        launch_count += 1
        fp32_launch_count += q.dtype == torch.float32
        _check_rc(rc)
    return (out, st) if stats else out


def _launch_backward(q, k, v, key_mask, o, do, stats):
    """One backward call on the card: the dQ pass, then the dK / dV pass."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == o.dtype == do.dtype) or q.dtype not in _DTYPES:
        raise ValueError("flash_sdpa_key_mask backward: one type (bf16 or fp32) for q, k, v, o, do")
    if stats.dtype != torch.float32 or tuple(stats.shape) != (2, B, H, Lq) \
            or not stats.is_contiguous():
        raise ValueError("flash_sdpa_key_mask backward: stats must be contiguous fp32 [2, B, H, Lq]")
    with _on_device(q):
        item = q.element_size()
        try:
            _strides("do", do.shape, do.stride(), item)
        except ValueError:
            do = do.contiguous()                 # autograd may hand any layout
        if do.data_ptr() % 16:
            do = do.clone()
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr())
        if any(p % 16 for p in ptrs):
            raise ValueError("flash_sdpa_key_mask backward: inputs must start on 16-byte boundaries")
        dq = _heads_last(B, H, Lq, D, q.dtype, q.device)
        dk = _heads_last(B, H, Lk, D, q.dtype, q.device)
        dv = _heads_last(B, H, Lk, D, q.dtype, q.device)
        delta = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        strides = _backward_strides(q.shape, k.shape, q.stride(), k.stride(), v.stride(),
                                    o.stride(), do.stride(), item)
        if key_mask is not None:
            key_mask = key_mask.contiguous()
        global backward_launch_count
        rc = _lib("flash_attention_tf32").stk_flash_attention_backward(
            *ptrs, None if key_mask is None else key_mask.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            delta.data_ptr(), B, H, Lq, Lk, D, _DTYPES[q.dtype], strides.ctypes.data, Lk,
            torch._C._cuda_getCurrentRawStream(q.get_device()))
        backward_launch_count += 1
        _check_rc(rc)
    return dq, dk, dv


@functools.lru_cache(maxsize=4096)
def _backward_strides(q_shape, k_shape, q_stride, k_stride, v_stride, o_stride, do_stride, item):
    """The backward call's (batch, head, row) strides of q, k, v, o, do, dq,
    dk, dv as a numpy int64 array, checked once per layout; the gradients
    are [B, L, H, D] memory."""
    B, H, Lq, D = q_shape
    Lk = k_shape[2]
    q_like, k_like = (Lq * H * D, D, H * D, 1), (Lk * H * D, D, H * D, 1)
    out = []
    for name, shape, stride in (("q", q_shape, q_stride), ("k", k_shape, k_stride),
                                ("v", k_shape, v_stride), ("o", q_shape, o_stride),
                                ("do", q_shape, do_stride), ("dq", q_shape, q_like),
                                ("dk", k_shape, k_like), ("dv", k_shape, k_like)):
        out.extend(_strides(name, shape, stride, item))
    arr = np.asarray(out, dtype=np.int64)
    arr.setflags(write=False)
    return arr
