"""Fused score + first-occurrence argmax over the VQ codebook: CUDA kernel,
its host planner, its plain PyTorch version and the launch counter.

Replaces the TPU kernel ``selftoktokenizer_tpu/ops/vq_kernels.py::vq_argmax``
(Pallas): ids = argmax_c z . E[c], first occurrence on ties, without ever
building the [N, C] score matrix in device memory.

A score is 16 fp32 fused multiply-adds in the order d = 0..15. The kernel
(``csrc/vq_argmax.cu``) screens every code on the TF32 tensor cores
(``wgmma``; z rounded to TF32, E truncated), bounds the screen's error by
``K_EPS * ||z|| * ||e||`` (proof in the source), and scores exactly only the
codes whose screen reaches the best lower bound seen less that bound; so its
ids are those of scoring every code exactly, at both tiers.
Bound on an H100: the TF32 products (2*N*C*16 at 495 TFLOP/s) or one
CUDA-core compare per score, whichever is larger; bytes are far below both.
The codebook is split ``plan_vq(N, C).splits`` ways so that the grid fills
the card; the last block of a row tile merges the splits. N and C need no
padding: the ragged edges are masked in the kernel.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from selftoktokenizer_tpu_torch.ops import _build

# launches of the CUDA kernel (and nothing else) since the last reset
launch_count = 0

CODE_DIM = 16
# the kernel's geometry and bound (csrc/vq_argmax.cu), mirrored for the planner
# and for the checks on the CPU
ROWS = 128                 # rows of z per block (csrc/vq_argmax.cu::ROWS)
TILE_C = 128               # codes per staged tile (csrc/vq_argmax.cu::TILE_C)
K_EPS = 1.5625 * 2.0 ** -10  # screen error bound factor (csrc/vq_argmax.cu::K_EPS)
NORM_FLOOR = 2.0 ** -50    # norms are floored here (csrc/vq_argmax.cu::NORM_FLOOR)
# the tensor core's accumulation allowance inside K_EPS (the source's proof)
TC_ACC_REL = 2.0 ** -17

SMS = 132                  # streaming multiprocessors of an H100 SXM
RESIDENT = 2               # blocks an SM holds at once (256 threads of ~120 registers)
MAX_SPLITS = 64


def _cdiv(a, b):
    return -(-a // b)


def _align(n, a=256):
    return _cdiv(n, a) * a


@dataclasses.dataclass(frozen=True)
class VQPlan:
    """How one call [N, 16] x [C, 16] is cut: row tiles of ROWS, the
    codebook's TILE_C-code tiles over ``splits`` splits, and the layout of
    the split scratch (per row tile and split, ROWS best scores, then ROWS
    ids)."""
    N: int
    C: int
    splits: int

    @functools.cached_property
    def tiles_n(self):
        return _cdiv(self.N, ROWS)

    @functools.cached_property
    def c_tiles(self):
        return _cdiv(self.C, TILE_C)

    @functools.cached_property
    def grid(self):
        return (self.tiles_n, self.splits)

    def code_range(self, split):
        """Codes [start, stop) of one split: the first c_tiles % splits
        splits take one tile more (the kernel's formula)."""
        per, rem = divmod(self.c_tiles, self.splits)
        start = split * per + min(split, rem)
        stop = start + per + (split < rem)
        return start * TILE_C, min(stop * TILE_C, self.C)

    @functools.cached_property
    def arg_offset(self):
        return _align(4 * self.tiles_n * self.splits * ROWS) if self.splits > 1 else 0

    @functools.cached_property
    def scratch_bytes(self):
        return 2 * self.arg_offset


@functools.lru_cache(maxsize=4096)
def plan_vq(N, C):
    """The codebook splits for z [N, 16] against E [C, 16]: as many as one
    wave of RESIDENT blocks an SM holds, then evened out so that every split
    takes about as many tiles. At the flagship N = 4096 takes 8 splits (256
    blocks), N = 16384 takes 2; a second wave measured slower (PERF.md)."""
    if N < 1 or C < 1:
        raise ValueError(f"vq_argmax: empty problem N={N}, C={C}")
    tiles_n = _cdiv(N, ROWS)
    if tiles_n >= 2 ** 31:
        raise ValueError(f"vq_argmax: N={N} exceeds the kernel's grid")
    c_tiles = _cdiv(C, TILE_C)
    splits = min(c_tiles, MAX_SPLITS, max(1, SMS * RESIDENT // tiles_n))
    return VQPlan(N, C, _cdiv(c_tiles, _cdiv(c_tiles, splits)))


def vq_argmax_plain(z, embed):
    """Plain version: argmax over the materialised fp32 score matrix.
    torch.argmax returns the first maximal index, the kernel's tie rule."""
    scores = z.float() @ embed.float().t()
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _lib():
    lib = _build.load("vq_argmax")
    if not getattr(lib, "_stk_typed", False):
        lib.stk_vq_argmax.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.stk_vq_argmax.restype = ctypes.c_int
        lib._stk_typed = True
    return lib


# per device and stream: the split-merge arrival counters, zeroed once; the
# kernel sets each back to 0 after its merge, so the next launch on the stream
# finds them zero. Launches on one stream run in order; two streams never
# share counters. (A launch that faults leaves the device's context unusable,
# counters and all.)
_counters = {}


def _counters_for(device, stream, n):
    key = (device, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def _check(z, embed):
    if z.ndim != 2 or embed.ndim != 2 or z.shape[1] != embed.shape[1]:
        raise ValueError(f"vq_argmax: bad shapes {tuple(z.shape)}, {tuple(embed.shape)}")
    if z.device != embed.device:
        raise ValueError("vq_argmax: z and embed lie on different devices")
    if z.device.type == "cpu":
        return
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
    if embed.shape[0] == 0:
        raise ValueError("vq_argmax: empty codebook")


def _launch(z, embed, plan, rescored=None):
    """One launch of the kernel on checked CUDA inputs under ``plan``;
    ``rescored``: None or [N] int32 zeros that receive each row's number of
    exactly scored codes."""
    n = z.shape[0]
    ids = torch.empty((n,), dtype=torch.int32, device=z.device)
    if n == 0:
        return ids
    global launch_count
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.splits > 1:
            scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8, device=z.device)
            best_ptr = scratch.data_ptr()
            arg_ptr = best_ptr + plan.arg_offset
            counters = _counters_for(z.device, stream, plan.tiles_n).data_ptr()
        else:
            best_ptr = arg_ptr = counters = None
        rc = _lib().stk_vq_argmax(
            z.data_ptr(), embed.data_ptr(), ids.data_ptr(), best_ptr, arg_ptr, counters,
            None if rescored is None else rescored.data_ptr(), n, embed.shape[0],
            plan.splits, stream)
    launch_count += 1
    if rc != 0:
        raise RuntimeError(f"vq_argmax: kernel launch failed (cudaError {rc})")
    return ids


def vq_argmax(z, embed, fast=False):
    """z: [N, 16] fp32 (l2-normalised), embed: [C, 16] fp32 -> ids [N] int32.

    fast=True is the serving tier's flag; the kernel's ids are exact at both
    tiers, so it is accepted and ignored. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.
    """
    del fast
    _check(z, embed)
    if z.device.type == "cpu":
        return vq_argmax_plain(z, embed)
    return _launch(z, embed, plan_vq(max(z.shape[0], 1), embed.shape[0]))


def vq_argmax_rescored(z, embed):
    """The kernel's ids and, per row, how many codes it scored exactly
    (CUDA tensors only): the measure of how well the screen prunes."""
    _check(z, embed)
    if z.device.type != "cuda":
        raise ValueError("vq_argmax_rescored: the count comes from the CUDA kernel")
    rescored = torch.zeros((z.shape[0],), dtype=torch.int32, device=z.device)
    ids = _launch(z, embed, plan_vq(max(z.shape[0], 1), embed.shape[0]), rescored)
    return ids, rescored
