"""Fused cosine-score + argmax over the VQ codebook: CUDA kernel, its plain
PyTorch version and the launch counter.

Replaces the TPU kernel ``selftoktokenizer_tpu/ops/vq_kernels.py::vq_argmax``
(Pallas): ids = argmax_c z . E[c], first occurrence on ties, without ever
building the [N, C] score matrix in device memory.

Bound on an H100: 2*N*C*16 FLOP on the fp32 CUDA cores (67 TFLOP/s; the
scores are exact fp32 FMAs, so no tensor core) against N*64 + C*64 + N*4
bytes; at the flagship (C = 32768) the operations bound it by three orders
of magnitude. The TPU kernel carries a running (best, arg) in scratch across
a sequential grid axis; blocks on a GPU run in no order, so here one block
owns a tile of rows and loops over the whole codebook itself, staging code
tiles through shared memory (the 2 MB codebook stays in L2). Every score is
16 ``__fmaf_rn`` in the fixed order d = 0..15, so it does not depend on the
tiling, and the merge rule "higher score wins, equal scores -> lower index"
makes the result the first-occurrence argmax exactly. N and C need no
padding: the ragged edges are masked in the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

CODE_DIM = 16


def vq_argmax_plain(z, embed):
    """Plain version: argmax over the materialised fp32 score matrix.
    torch.argmax returns the first maximal index, the kernel's tie rule."""
    scores = z.float() @ embed.float().t()
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _lib():
    lib = _build.load("vq_argmax")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_vq_argmax.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.stk_vq_argmax.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


def vq_argmax(z, embed, fast=False):
    """z: [N, 16] fp32 (l2-normalised), embed: [C, 16] fp32 -> ids [N] int32.

    fast=True is the serving tier's flag; it runs the same exact-fp32 kernel
    (more precise than that tier asks for). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    """
    del fast
    if z.ndim != 2 or embed.ndim != 2 or z.shape[1] != embed.shape[1]:
        raise ValueError(f"vq_argmax: bad shapes {tuple(z.shape)}, {tuple(embed.shape)}")
    if z.device != embed.device:
        raise ValueError("vq_argmax: z and embed lie on different devices")
    if z.device.type == "cpu":
        return vq_argmax_plain(z, embed)
    if z.device.type != "cuda":
        raise ValueError(f"vq_argmax: unsupported device {z.device}")
    if z.dtype != torch.float32 or embed.dtype != torch.float32:
        raise ValueError("vq_argmax: the kernel takes fp32 inputs")
    if z.shape[1] != CODE_DIM:
        raise ValueError(f"vq_argmax: the kernel takes code_dim {CODE_DIM}, got {z.shape[1]}")
    if not (z.is_contiguous() and embed.is_contiguous()):
        raise ValueError("vq_argmax: the kernel takes contiguous inputs")
    if z.data_ptr() % 16 or embed.data_ptr() % 16:
        raise ValueError("vq_argmax: inputs must be 16-byte aligned")
    n, c = z.shape[0], embed.shape[0]
    ids = torch.empty((n,), dtype=torch.int32, device=z.device)
    if n == 0:
        return ids
    if c == 0:
        raise ValueError("vq_argmax: empty codebook")
    global launch_count
    with torch.cuda.device(z.device):
        rc = _lib().stk_vq_argmax(
            z.data_ptr(), embed.data_ptr(), ids.data_ptr(), n, c,
            torch.cuda.current_stream().cuda_stream)
    launch_count += 1
    if rc != 0:
        raise RuntimeError(f"vq_argmax: kernel launch failed (cudaError {rc})")
    return ids
