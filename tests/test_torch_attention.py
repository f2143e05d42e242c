"""The attention kernel's host side on the CPU: its shared memory, the C
call's sizes and strides at the main path's shapes and for the qkv split's
views, and the wrapper (its plain route on the CPU) against the Pallas
kernel in interpret mode at the decode's bucket lengths and on strided
views.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version on the card at these shapes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.ops.flash_attention import flash_sdpa_key_mask as j_flash
from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from tests.torch_port_helpers import to_np

# (B, H, Lq, Lk) of every bf16 attention call on the main path: the decode's
# joint attention at each context bucket (Lq = Lk = 256 + 128 k), its uncond
# x-only call, the encoder's query attention, the renderer's two calls
MAIN_PATH = [(2, 24, 768, 768), (8, 8, 512, 768), (2, 24, 256, 256), (8, 24, 512, 512),
             (8, 24, 256, 768), (2, 24, 384, 384), (2, 24, 512, 512), (2, 24, 640, 640)]
SM_SMEM = 233472               # shared memory of one SM; a block reserves 1 KB of it


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
def test_shared_memory_of_each_instantiation_fits_and_aligns(D):
    # the layout of Tile<D> in csrc/flash_attention.cu, from the 1024-aligned base
    sub, st = D // 64, fa.STAGES[D]
    q_bytes, kv_bytes = sub * fa.BM * 128, sub * fa.BN * 128
    ring = q_bytes
    bias = ring + st * 2 * kv_bytes
    bars = bias + st * fa.BN * 4
    flags = bars + (1 + 2 * st) * 8
    end = flags + st * 4
    # Q and every K or V tile start on 1024 bytes (the 128-byte swizzle's
    # period), the bias rows on 8 (float2 reads), the mbarriers on 8
    assert q_bytes % 1024 == 0 and kv_bytes % 1024 == 0 and ring % 1024 == 0
    assert bias % 8 == 0 and bars % 8 == 0 and flags % 4 == 0
    assert fa.smem_bytes(D) == 1024 + end <= fa.SMEM_LIMIT
    # a ring deep enough to keep a tile in flight while one is computed
    assert st >= 2
    # D = 64: three blocks share an SM, as the kernel's launch bounds ask
    blocks = 3 if D == 64 else 1
    assert blocks * (fa.smem_bytes(D) + 1024) <= SM_SMEM


def _views(B, H, L, D, layout):
    """Three [B, H, L, D] tensors on the meta device: dense, or the views the
    qkv split makes of one [B, L, 3, H, D] tensor."""
    if layout == "dense":
        return tuple(torch.empty((B, H, L, D), device="meta") for _ in range(3))
    t = torch.empty((B, L, 3, H, D), device="meta")
    return tuple(t[:, :, i].permute(0, 2, 1, 3) for i in range(3))


@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("layout", ["dense", "qkv"])
@pytest.mark.parametrize("B,H,Lq,Lk", MAIN_PATH)
def test_call_args_at_the_main_path_shapes(B, H, Lq, Lk, layout, D):
    q = _views(B, H, Lq, D, layout)[0]
    _, k, v = _views(B, H, Lk, D, layout)
    args = fa._call_args(q.shape, k.shape, q.stride(), k.stride(), v.stride(), 2, 0)
    assert args[:6] == (B, H, Lq, Lk, D, 0)
    # (batch, head, row) strides of q, k, v as given, then the output's
    # [B, Lq, H, D] memory, then the mask's row
    assert args[6:9] == q.stride()[:3] and args[9:12] == k.stride()[:3]
    assert args[12:15] == v.stride()[:3]
    assert args[15:18] == (Lq * H * D, D, H * D) and args[18:] == (Lk,)
    # the grid: one block per 64 query rows and (batch, head), within CUDA's limits
    assert B * H <= fa.GRID_Y_LIMIT and -(-Lq // fa.BM) < 2 ** 31


@pytest.mark.parametrize("D,dtype,ok", [(64, torch.bfloat16, True), (128, torch.bfloat16, True),
                                        (64, torch.float32, True), (128, torch.float32, True),
                                        (96, torch.bfloat16, False), (64, torch.float16, False)])
def test_supported_names_what_the_kernel_takes(D, dtype, ok):
    q = torch.empty((1, 2, 5, D), dtype=dtype, device="meta")
    assert fa.supported(q, q) is ok
    assert not fa.supported(q[:, :, :0], q)


def qkv_split(seed, B, L, H, D=64):
    """The models' qkv split: one [B, L, 3, H, D] array, and the three
    [B, H, L, D] views of it (row stride 3*H*D, head stride D)."""
    a = np.random.default_rng(seed).standard_normal((B, L, 3, H, D)).astype(np.float32)
    t = torch.from_numpy(a)
    views = tuple(t[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    dense = tuple(np.ascontiguousarray(a[:, :, i].transpose(0, 2, 1, 3)) for i in range(3))
    return views, dense


def test_call_args_of_qkv_split_views_and_output_layout():
    (q, k, v), _ = qkv_split(0, 2, 300, 4)
    assert q.stride() == (300 * 3 * 4 * 64, 64, 3 * 4 * 64, 1)
    args = fa._call_args(q.shape, k.shape, q.stride(), k.stride(), v.stride(), 2, 0)
    B, H, Lq, Lk, D, dtype = args[:6]
    assert (B, H, Lq, Lk, D, dtype) == (2, 4, 300, 300, 64, 0)
    # (batch, head, row) strides of q, k, v as given, then the output's
    # [B, Lq, H, D] memory, the mask's row
    split = (300 * 3 * 4 * 64, 64, 3 * 4 * 64)
    assert args[6:9] == args[9:12] == args[12:15] == split
    assert args[15:18] == (300 * 4 * 64, 64, 4 * 64)
    assert args[18:] == (300,)


def test_call_args_replace_strides_of_size_one_dims_and_refuse_unaligned_rows():
    # a size-1 dimension may carry any stride; the maps get one they accept
    assert fa._strides("q", (1, 1, 5, 64), (7, 3, 64, 1), 2) == (320, 320, 64)
    with pytest.raises(ValueError):
        fa._strides("q", (1, 2, 5, 64), (640, 320, 65, 1), 2)        # rows 130 bytes apart
    with pytest.raises(ValueError):
        fa._strides("q", (1, 2, 5, 64), (640, 1, 64, 2), 2)          # not dense in D


# bf16 on both sides: products of bf16 values accumulated in fp32, weights
# rounded to bf16 before P V, output rounded to bf16 (2e-2, the tolerance of
# the Pallas kernel's own tests); fp32: summation order only (2e-5)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("L", [384, 640])
def test_flash_at_the_decode_buckets_matches_pallas_interpret(L, dtype, tol):
    rng = np.random.default_rng(L)
    q, k, v = (rng.standard_normal((1, 2, L, 64)).astype(np.float32) for _ in range(3))
    # the decode's mask: a prefix of the context keys active, every x key active
    km = np.arange(L)[None, :] < np.array([[L // 3]])
    km |= np.arange(L)[None, :] >= L - 256
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), jnp.asarray(km),
                   interpret=True)
    got = fa.flash_sdpa_key_mask(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                                 torch.from_numpy(km))
    assert got.dtype == td and tuple(got.shape) == (1, 2, L, 64)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("masked", [False, True])
def test_flash_on_qkv_split_views_matches_pallas_interpret(masked):
    (q, k, v), dense = qkv_split(1, 2, 256, 3)
    km = None
    if masked:
        km = np.random.default_rng(2).random((2, 256)) > 0.4
        km[:, 0] = True
    want = j_flash(*(jnp.asarray(a, jnp.bfloat16) for a in dense),
                   None if km is None else jnp.asarray(km), interpret=True)
    got = fa.flash_sdpa_key_mask(q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
                                 None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2, atol=2e-2)
    # the strided views in fp32, unrounded, against the same values made dense
    got32 = fa.flash_sdpa_key_mask(q, k, v, None if km is None else torch.from_numpy(km))
    ref32 = fa.flash_sdpa_key_mask_plain(*(torch.from_numpy(a) for a in dense),
                                         None if km is None else torch.from_numpy(km))
    np.testing.assert_allclose(to_np(got32), to_np(ref32), rtol=1e-6, atol=1e-6)

