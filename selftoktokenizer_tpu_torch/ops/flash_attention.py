"""Fused softmax attention with an optional per-key mask: CUDA kernel
(forward), its plain PyTorch version and the launch counter.

Replaces the TPU kernel
``selftoktokenizer_tpu/ops/flash_attention.py::_flash_mha`` (Pallas), entered
through ``flash_sdpa_key_mask``: softmax(q k^T / sqrt(D) + bias) v per
(batch, head), where a per-key mask [B, Lk] (True = attend) becomes a finite
-1e30 bias broadcast over heads and queries; softmax in fp32, weights cast
to ``v.dtype`` before P V.

Bound on an H100: 4*B*H*Lq*Lk*D FLOP (bf16 tensor cores, 989 TFLOP/s; fp32
inputs run on the fp32 CUDA cores, 67 TFLOP/s) against
(2*Lq + 2*Lk)*D*B*H*itemsize bytes at 3.35 TB/s, and B*H*Lq*Lk exponentials
(16 a clock on each SM's special-function units). The TPU kernel holds a
head's whole K and V in fast memory and does one softmax pass; on Hopper a
block has 227 KB, so the kernel (``csrc/flash_attention.cu``) walks K/V in
tiles through a TMA-fed ring with an online softmax, runs both products
with ``wgmma`` in bf16 and overlaps one tile's exponentials with the
previous tile's P V. Any Lq and Lk are accepted: the ragged tiles are
masked in the kernel. q, k and v may be strided views (the qkv split's);
the output is allocated in [B, Lq, H, D] memory and returned as a
[B, H, Lq, D] view, so merging the heads after it is free.

Gradients: ``flash_sdpa_key_mask`` is a ``torch.autograd.Function`` whose
forward is the kernel (the plain version on a CPU tensor) and whose backward
is the reference's ``_make_flash_vjp`` backward, which is an fp32 recompute
and no TPU kernel: the scores are rebuilt in fp32 with the key bias, then
P = softmax, dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
dQ = dS K * scale and dK = dS^T Q * scale, each cast to its input's type;
the mask gets no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

NEG = -1e30
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


def supported(q, k):
    """Whether the kernel takes these shapes and types (on any device)."""
    return (q.ndim == 4 and q.shape[-1] in HEAD_DIMS and q.dtype in _DTYPES
            and k.shape[2] > 0 and q.shape[2] > 0)


def flash_sdpa_key_mask_plain(q, k, v, key_mask=None):
    """Plain version, the kernel's arithmetic written out: products of the
    input type accumulated in fp32, the finite -1e30 key bias, fp32 softmax,
    weights cast to v.dtype before the second product."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, NEG).to(torch.float32)
        s = s + bias[:, None, None, :]
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_flash_attention.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 13
            + [ctypes.c_void_p])
        lib.stk_flash_attention.restype = ctypes.c_int
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


def _forward(q, k, v, key_mask):
    """The kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return flash_sdpa_key_mask_plain(q, k, v, key_mask)
    return _launch(q, k, v, key_mask)


def flash_sdpa_key_mask_backward(q, k, v, key_mask, do):
    """(dq, dk, dv) of the attention at (q, k, v, key_mask) for the output
    gradient do, recomputed in fp32 as the reference's backward does. The
    [B,H,Lq,Lk] passes are few: the scale and the key bias are applied in
    the first product's epilogue, and dS is formed in dP's memory."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf = (t.float().reshape(B * H, -1, D) for t in (q, k, v))
    kt = kf.transpose(1, 2)
    if key_mask is None:
        s = torch.bmm(qf, kt).mul_(scale)
    else:
        bias = torch.where(key_mask, 0.0, NEG).to(torch.float32)
        s = torch.baddbmm(bias[:, None, None, :].expand(B, H, 1, Lk).reshape(B * H, 1, Lk),
                          qf, kt, alpha=scale)
    p = torch.softmax(s, dim=-1)
    del s
    dof = do.float().reshape(B * H, Lq, D)
    dv = torch.bmm(p.transpose(1, 2), dof)
    dp = torch.bmm(dof, vf.transpose(1, 2))
    ds = dp.sub_(torch.sum(dp * p, dim=-1, keepdim=True)).mul_(p)
    del p
    dq = torch.bmm(ds, kf).mul_(scale)
    dk = torch.bmm(ds.transpose(1, 2), qf).mul_(scale)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


class _FlashSdpaKeyMask(torch.autograd.Function):
    """The kernel forward on detached inputs; the fp32 recompute backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask):
        ctx.save_for_backward(q, k, v, key_mask)
        return _forward(q.detach(), k.detach(), v.detach(), key_mask)

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask = ctx.saved_tensors
        dq, dk, dv = flash_sdpa_key_mask_backward(q, k, v, key_mask, do)
        return dq, dk, dv, None


def _launch(q, k, v, key_mask):
    """One launch on the card."""
    dev = q.get_device()
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(q, k, v, key_mask)
    B, H, Lq, D = q.shape
    args = _call_args(q.shape, k.shape, q.stride(), k.stride(), v.stride(), q.element_size(),
                      _DTYPES[q.dtype])
    # [B, Lq, H, D] memory: merging the heads afterwards is a free reshape
    out = torch.empty_strided((B, H, Lq, D), (Lq * H * D, D, H * D, 1), dtype=q.dtype, device=q.device)
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError("flash_sdpa_key_mask: q, k and v must start on 16-byte boundaries")
    global launch_count
    rc = _lib().stk_flash_attention(
        *ptrs, out.data_ptr(), None if key_mask is None else key_mask.data_ptr(), *args,
        torch._C._cuda_getCurrentRawStream(dev))
    launch_count += 1
    _check_rc(rc)
    return out
