"""3x3 SAME stride-1 convolution from 3 input channels (the VAE encoder's
``conv_in`` stem): CUDA kernel, its plain PyTorch version and the launch
counter.

Replaces the TPU kernel ``selftoktokenizer_tpu/ops/conv3ch.py::conv3ch_3x3``
(Pallas): out[b,h,w,:] = sum over the 27 taps (dy, dx, c) of the padded
input times the weight cast to x's type, accumulated in fp32, plus the bias
in fp32, cast to x's type. As in the JAX package it is wired into nothing:
the port's VAE keeps its cuDNN convolution until a measurement on the card
says otherwise.

Bound on an H100: the output stream (at [8,256,256,3] -> 128 channels,
134 MB in bf16 against 3 MB of input and 3.6 GFLOP). The kernel
(``csrc/conv3ch.cu``) is persistent over image rows: each block loads the
weights once and double-buffers the input bands with cp.async, so no patch
tensor is ever written. bf16 sums on the tensor cores (``mma.sync``
m16n8k16, the 27 taps padded to 32), fp32 on the CUDA cores with each
thread's weights in registers; the output leaves as 16-byte vectors in
contiguous runs. Unlike the TPU kernel it takes any H, W and C whose
shared memory fits a block, and x need only be aligned to its type.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

_DTYPES = {torch.bfloat16: 1, torch.float32: 0}
SMEM_LIMIT = 232_448      # bytes of shared memory a block may use on Hopper


def conv3ch_3x3_plain(x, w, b):
    """Plain version, the TPU kernel's im2col form: the 27 taps in (dy, dx,
    c) order, the weight cast to x's type, one product accumulated in fp32,
    the bias added in fp32, the result cast to x's type."""
    B, H, W, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    patches = torch.cat([xp[:, dy:dy + H, dx:dx + W, :]
                         for dy in range(3) for dx in range(3)], dim=-1)   # [B,H,W,27]
    wk = w.permute(2, 3, 1, 0).reshape(27, -1).to(x.dtype)                 # (dy, dx, c) x C
    acc = patches.float() @ wk.float() + b.float()
    return acc.to(x.dtype)


def _lib():
    lib = _build.load("conv3ch")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_conv3ch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.stk_conv3ch.restype = ctypes.c_int
        lib.stk_conv3ch_smem.argtypes = [ctypes.c_int] * 3
        lib.stk_conv3ch_smem.restype = ctypes.c_longlong
        lib._stk_typed = True
    return lib


def conv3ch_3x3(x, w, b):
    """x: NHWC [B, H, W, 3] bf16 or fp32; w: torch's OIHW [C, 3, 3, 3];
    b: [C] -> NHWC [B, H, W, C] of x's type.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises (w and b must then be fp32, as the port stores weights).
    """
    if x.ndim != 4 or x.shape[3] != 3 or w.ndim != 4 or tuple(w.shape[1:]) != (3, 3, 3) \
            or tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"conv3ch_3x3: bad shapes {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if not (x.device == w.device == b.device):
        raise ValueError("conv3ch_3x3: inputs lie on different devices")
    if x.device.type == "cpu":
        return conv3ch_3x3_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv3ch_3x3: unsupported device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("conv3ch_3x3: the kernel takes bf16 or fp32 x and fp32 w and b")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv3ch_3x3: the kernel takes contiguous inputs")
    B, H, W, _ = x.shape
    C = w.shape[0]
    if B * H >= 2 ** 31:
        raise ValueError(f"conv3ch_3x3: {B} x {H} image rows exceed the kernel's row index")
    lib = _lib()
    if lib.stk_conv3ch_smem(W, C, _DTYPES[x.dtype]) > SMEM_LIMIT:
        raise ValueError(f"conv3ch_3x3: width {W} with {C} channels needs more shared "
                         f"memory than a block has")
    out = torch.empty((B, H, W, C), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    global launch_count
    with torch.cuda.device(x.device):
        rc = lib.stk_conv3ch(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                             B, H, W, C, _DTYPES[x.dtype],
                             torch.cuda.current_stream().cuda_stream)
    launch_count += 1
    if rc != 0:
        raise RuntimeError(f"conv3ch_3x3: kernel launch failed (cudaError {rc})")
    return out
