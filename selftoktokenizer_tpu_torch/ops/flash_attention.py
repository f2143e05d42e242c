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
(2*Lq + 2*Lk)*D*B*H*itemsize bytes at 3.35 TB/s; at the flagship shapes the
operations bound it. The TPU kernel holds a head's whole K and V in fast
memory and does one softmax pass; on Hopper a block has 227 KB, so the
kernel (``csrc/flash_attention.cu``) walks K/V in 64-key tiles through
shared memory with an online softmax and never writes the [Lq, Lk] scores to
device memory. Any Lq and Lk are accepted: the ragged tiles are masked in
the kernel. Forward only; the backward goes with training.
"""

from __future__ import annotations

import ctypes
import math

import torch

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

NEG = -1e30
HEAD_DIMS = (64, 128)
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


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
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
            + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
        lib.stk_flash_attention.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


def _strides(name, t):
    """(batch, head, row) strides in elements of a [B,H,L,D] tensor whose
    last dimension is dense; rows must start on 16-byte boundaries."""
    if t.stride(3) != 1:
        raise ValueError(f"flash_sdpa_key_mask: {name} must be dense in its last dimension")
    item = t.element_size()
    if t.data_ptr() % 16 or any((s * item) % 16 for s in t.stride()[:3]):
        raise ValueError(f"flash_sdpa_key_mask: {name} rows must be 16-byte aligned")
    return t.stride()[:3]


def flash_sdpa_key_mask(q, k, v, key_mask=None):
    """q: [B,H,Lq,D]; k, v: [B,H,Lk,D]; D in {64, 128}; bf16 or fp32;
    key_mask: optional bool [B, Lk], True = attend. -> [B,H,Lq,D].

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
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_sdpa_key_mask is forward only: inputs must not require grad")
    if not (q.device == k.device == v.device) or \
            (key_mask is not None and key_mask.device != q.device):
        raise ValueError("flash_sdpa_key_mask: inputs lie on different devices")
    if q.device.type == "cpu":
        return flash_sdpa_key_mask_plain(q, k, v, key_mask)
    if q.device.type != "cuda":
        raise ValueError(f"flash_sdpa_key_mask: unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError("flash_sdpa_key_mask: the kernel takes bf16 or fp32, one type for q, k, v")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_sdpa_key_mask: the kernel takes head dim 64 or 128, got {D}")
    if Lq == 0 or Lk == 0 or B * H == 0 or B * H > 65535:
        raise ValueError(f"flash_sdpa_key_mask: unsupported sizes B*H={B * H}, Lq={Lq}, Lk={Lk}")
    out = torch.empty((B, H, Lq, D), dtype=q.dtype, device=q.device)
    if key_mask is not None:
        key_mask = key_mask.contiguous()
    strides = (*_strides("q", q), *_strides("k", k), *_strides("v", v),
               *_strides("out", out), Lk)
    global launch_count
    with torch.cuda.device(q.device):
        rc = _lib().stk_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if key_mask is None else key_mask.data_ptr(),
            B, H, Lq, Lk, D, _DTYPES[q.dtype], *strides,
            torch.cuda.current_stream().cuda_stream)
    launch_count += 1
    if rc != 0:
        raise RuntimeError(f"flash_sdpa_key_mask: kernel launch failed (cudaError {rc})")
    return out
