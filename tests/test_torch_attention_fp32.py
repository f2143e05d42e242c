"""The split-TF32 attention kernels' design on the CPU: a model of their
arithmetic against the reference, the plain versions of their inputs and
outputs (row statistics, the backward) against ``jax.vjp``, and their
shared memory and call arguments at the main path's shapes.

The CUDA kernels (``csrc/flash_attention_tf32.cu``) cannot run here;
chip_smoke.py holds them against these plain versions on the card.

Tolerances: the split-TF32 model within half of the card's gates
(chip_smoke.py: fp32 output 2e-5, gradients 1e-4 of each gradient's largest
value), so the design can meet them; the plain fp32 versions within 1e-5,
as tests/test_torch_attention_grad.py holds the wrapper."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selftoktokenizer_tpu.ops.attention import sdpa_key_mask as j_sdpa_key_mask
from selftoktokenizer_tpu.ops.flash_attention import flash_sdpa_key_mask as j_flash
from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from tests.torch_port_helpers import to_np

SMEM_LIMIT = 232448           # shared memory a block can have
SM_SMEM = 233472              # shared memory of one SM; a block reserves 1 KB of it


# ------------------------------------------------------ split-TF32 model ---

def tf32(x):
    """Round fp32 to TF32 by bits, to nearest with ties away from zero
    (cvt.rna.tf32.f32): the low 13 mantissa bits dropped."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x):
    """x = hi + lo: hi rounded to TF32, lo = x - hi (exact in fp32) as the
    tensor core reads it, truncated to TF32."""
    hi = tf32(x)
    lo = x - hi
    return hi, (lo.view(torch.int32) & ~0x1FFF).view(torch.float32)


def mm3(a, b):
    """a @ b in split TF32: hi*hi + hi*lo + lo*hi, each product exact in
    fp32 (11 x 11 significant bits), the sums in fp32."""
    (ah, al), (bh, bl) = split(a), split(b)
    return torch.matmul(al, bh) + torch.matmul(ah, bl) + torch.matmul(ah, bh)


def model_forward(q, k, v, mask):
    """The fp32 forward kernel's arithmetic: S in split TF32, x = S * scale
    * log2(e) + bias, the softmax in fp32 (exp2 against the row max), the
    unnormalised P V in split TF32, then / l. Returns (out, m, l)."""
    x = mm3(q, k.transpose(-1, -2)) * (fa.LOG2E / math.sqrt(q.shape[-1]))
    if mask is not None:
        x = x + torch.where(mask, 0.0, fa.NEG)[:, None, None, :]
    m = x.amax(dim=-1, keepdim=True)
    e = torch.exp2(x - m)
    l = e.sum(dim=-1, keepdim=True)
    return mm3(e, v) / l, m, l


def model_backward(q, k, v, mask, o, do, m, l):
    """The backward kernels' arithmetic: P from the forward's m and l, its
    five products in split TF32, Delta = rowsum(dO * O)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    x = mm3(q, k.transpose(-1, -2)) * (fa.LOG2E * scale)
    if mask is not None:
        x = x + torch.where(mask, 0.0, fa.NEG)[:, None, None, :]
    p = torch.exp2(x - m) / l
    dv = mm3(p.transpose(-1, -2), do)
    dp = mm3(do, v.transpose(-1, -2))
    ds = p * (dp - (do * o).sum(dim=-1, keepdim=True))
    return mm3(ds, k) * scale, mm3(ds.transpose(-1, -2), q) * scale, dv


def _inputs(seed, B, H, Lq, Lk, D, spread, mask_kind):
    rng = np.random.default_rng(seed)
    q, k = (spread * rng.standard_normal((B, H, L, D)).astype(np.float32) for L in (Lq, Lk))
    v = rng.standard_normal((B, H, Lk, D)).astype(np.float32)
    do = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    mask = None
    if mask_kind == "random":
        mask = rng.random((B, Lk)) > 0.4
        mask[:, 0] = True
    elif mask_kind == "prefix":
        mask = np.arange(Lk)[None, :] < rng.integers(1, Lk, (B, 1))
        mask[:, Lk - 64:] = True
    elif mask_kind == "full_row":
        mask = rng.random((B, Lk)) > 0.4
        mask[:, 0] = True
        mask[0] = False
    return q, k, v, do, mask


def _jax_vjp(q, k, v, mask, do, flash=True):
    """Output and gradients of the reference: the Pallas kernel in interpret
    mode at HIGHEST and its custom VJP, or (flash False: lengths the Pallas
    kernel cannot tile) ``sdpa_key_mask``, the same function in XLA."""
    jm = None if mask is None else jnp.asarray(mask)
    if flash:
        fn = lambda a, b, c: j_flash(a, b, c, jm, interpret=True,
                                     precision=jax.lax.Precision.HIGHEST)
    else:
        fn = lambda a, b, c: j_sdpa_key_mask(a, b, c, jm)
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (out,) + vjp(jnp.asarray(do))


def _close_to_scale(got, want, frac):
    got, want = to_np(got), to_np(want)
    assert np.isfinite(got).all()
    return np.abs(got - want).max() <= frac * np.abs(want).max()


# D, spread of q and k (2.6: scores of magnitude ~30), mask
MODEL_CASES = [(64, 1.0, "random"), (64, 2.6, None), (128, 2.6, "prefix")]


def _exact(q, k, v, mask, do):
    """Output and gradients in float64."""
    t = [torch.from_numpy(a).double().requires_grad_() for a in (q, k, v)]
    s = torch.matmul(t[0], t[1].transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if mask is not None:
        s = s + torch.where(torch.from_numpy(mask), 0.0, -1e30).double()[:, None, None, :]
    out = torch.matmul(torch.softmax(s, dim=-1), t[2])
    return (out,) + torch.autograd.grad(out, t, torch.from_numpy(do).double())


@pytest.mark.parametrize("D,spread,mask_kind", MODEL_CASES)
def test_split_tf32_model_meets_half_of_the_card_gates(D, spread, mask_kind):
    q, k, v, do, mask = _inputs(D + int(10 * spread), 2, 2, 128, 192, D, spread, mask_kind)
    j_out, j_dq, j_dk, j_dv = _jax_vjp(q, k, v, mask, do)
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    tm = None if mask is None else torch.from_numpy(mask)
    out, m, l = model_forward(t[0], t[1], t[2], tm)
    x_out = _exact(q, k, v, mask, do)[0].detach().numpy()
    err = np.abs(to_np(out) - x_out).max()
    if spread > 1:
        s = torch.matmul(t[0], t[1].transpose(-1, -2)) / math.sqrt(D)
        assert 25 <= float(s.abs().max()) <= 60               # the scores the case is for
        # at scores of ~30 fp32 itself is ~1e-5 off (the reference's own
        # products and softmax: 8.7e-6 at D = 64, 1.6e-5 at D = 128, against
        # float64): the design adds at most half of the card's 2e-5 to what
        # the reference loses
        assert err <= np.abs(to_np(j_out) - x_out).max() + 1e-5
    else:
        assert np.abs(to_np(out) - to_np(j_out)).max() <= 1e-5    # half of chip_smoke's 2e-5
        assert err <= 1e-5
    grads = model_backward(t[0], t[1], t[2], tm, out, t[3], m, l)
    for got, want in zip(grads, (j_dq, j_dk, j_dv)):
        assert _close_to_scale(got, want, 5e-5)               # half of 1e-4 of scale


def test_tf32_rounds_to_nearest_with_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 + 2.0 ** -20, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0], dtype=torch.float32)
    want = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0])
    assert torch.equal(tf32(x), want)
    # the kernel's rounding of hi in integers: (bits + 0x1000) & ~0x1fff
    bits = x.view(torch.int32)
    assert torch.equal(((bits + 0x1000) & ~0x1FFF).view(torch.float32), want)
    hi, lo = split(torch.tensor([math.pi], dtype=torch.float32))
    assert float(hi) + float(lo) == pytest.approx(math.pi, rel=2.0 ** -20)


# -------------------------------------------- plain versions against JAX ---

# (name, B, H, Lq, Lk, D, mask kind, layout)
PLAIN_CASES = [
    ("fully_masked_row", 2, 2, 128, 192, 64, "full_row", "dense"),
    ("ragged_lengths", 2, 3, 77, 129, 64, "random", "dense"),
    ("ragged_head_dim_128", 1, 2, 130, 257, 128, "full_row", "dense"),
    ("qkv_views", 2, 3, 100, 100, 64, "random", "qkv"),
]


@pytest.mark.parametrize("case", PLAIN_CASES, ids=[c[0] for c in PLAIN_CASES])
def test_plain_stats_and_backward_match_the_reference_vjp(case):
    name, B, H, Lq, Lk, D, mask_kind, layout = case
    q, k, v, do, mask = _inputs(len(name), B, H, Lq, Lk, D, 1.0, mask_kind)
    if layout == "qkv":
        leaf = torch.from_numpy(np.stack([q, k, v], axis=2).transpose(0, 3, 2, 1, 4).copy())
        tq, tk, tv = (leaf[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        assert tq.stride() == (Lq * 3 * H * D, D, 3 * H * D, 1)
    else:
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out, stats = fa.flash_sdpa_key_mask_plain(tq, tk, tv, tm, stats=True)
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, B, H, Lq)
    # the statistics: m the largest x = s * scale * log2(e) + bias, l the
    # sum of exp2(x - m), against float64
    x = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64))
    x *= math.log2(math.e) / math.sqrt(D)
    if mask is not None:
        x = x + np.where(mask, 0.0, -1e30)[:, None, None, :]
    m64 = x.max(axis=-1)
    np.testing.assert_allclose(stats[0].numpy(), m64, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(stats[1].numpy(), np.exp2(x - m64[..., None]).sum(-1), rtol=1e-5)
    if mask_kind == "full_row":
        # a row with every key masked: m = -1e30, every key's weight 2^0, l = Lk
        assert np.all(stats[0, 0].numpy() == np.float32(-1e30))
        assert np.all(stats[1, 0].numpy() == Lk)
    dq, dk, dv = fa.flash_sdpa_key_mask_backward_plain(tq, tk, tv, tm, out, torch.from_numpy(do),
                                                       stats)
    want = _jax_vjp(q, k, v, mask, do, flash=False)
    for got, w in zip((out, dq, dk, dv), want):
        assert got.dtype == torch.float32 and tuple(got.shape) == tuple(w.shape)
        np.testing.assert_allclose(to_np(got), to_np(w), rtol=1e-5, atol=1e-5)


def test_the_cpu_backward_takes_the_plain_version_and_counts_nothing():
    q, k, v, do, mask = _inputs(5, 1, 2, 64, 96, 64, 1.0, "random")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm, tdo = torch.from_numpy(mask), torch.from_numpy(do)
    before = (fa.launch_count, fa.backward_launch_count)
    out = fa.flash_sdpa_key_mask(tq, tk, tv, tm)
    grads = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert (fa.launch_count, fa.backward_launch_count) == before
    o, stats = fa.flash_sdpa_key_mask_plain(tq.detach(), tk.detach(), tv.detach(), tm, stats=True)
    want = fa.flash_sdpa_key_mask_backward(tq.detach(), tk.detach(), tv.detach(), tm, o, tdo, stats)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


# ----------------------------------------- shared memory and call arguments ---

KERNEL_TYPES = [(name, D, dtype) for name, (_, _, types) in fa.TF32_KERNELS.items()
                for D in fa.HEAD_DIMS for dtype in types]


@pytest.mark.parametrize("name,D,dtype", KERNEL_TYPES,
                         ids=[f"{n}-{d}-{str(t)[6:]}" for n, d, t in KERNEL_TYPES])
def test_shared_memory_of_each_tf32_instantiation_fits_and_aligns(name, D, dtype):
    # the layout of Smem<T, D, OWN, SIDE> in csrc/flash_attention_tf32.cu,
    # from the 1024-aligned base
    own, side, _ = fa.TF32_KERNELS[name]
    st = fa.TF32_STAGES
    tile = 64 * D * (2 if dtype == torch.bfloat16 else 4)
    ring = own * tile
    side_off = ring + st * 2 * tile
    bars = side_off + st * side * 4
    end = bars + (1 + 2 * st) * 8
    # every tile and every 128-byte column block of one starts on 1024 bytes
    # (the 128-byte swizzle's period); the side data on 8 (float2 reads),
    # the mbarriers on 8
    assert tile % 8192 == 0 and ring % 1024 == 0 and side_off % 1024 == 0
    assert (side * 4) % 8 == 0 and bars % 8 == 0
    assert fa.tf32_smem_bytes(name, D, dtype) == 1024 + end <= SMEM_LIMIT
    assert st >= 2
    # D = 64: two blocks share an SM, as the kernels' launch bounds ask
    blocks = 2 if D == 64 else 1
    assert blocks * (fa.tf32_smem_bytes(name, D, dtype) + 1024) <= SM_SMEM


def _views(B, H, L, D, layout):
    if layout == "dense":
        return tuple(torch.empty((B, H, L, D), device="meta") for _ in range(3))
    t = torch.empty((B, L, 3, H, D), device="meta")
    return tuple(t[:, :, i].permute(0, 2, 1, 3) for i in range(3))


# (B, H, Lq, Lk, layout) of every fp32 attention call on the training paths:
# the tokenizer's joint attention (and on one rank's heads at tensor 2 and
# 4), the renderer's context rows (qkv views) and x rows, the
# multi-resolution tokenizer's joint attention
TRAIN_PATH = [(4, 24, 768, 768, "dense"), (4, 12, 768, 768, "dense"), (4, 6, 768, 768, "dense"),
              (4, 24, 512, 512, "qkv"), (4, 24, 256, 768, "dense"), (4, 24, 1280, 1280, "dense")]


@pytest.mark.parametrize("B,H,Lq,Lk,layout", TRAIN_PATH)
def test_call_args_of_the_fp32_forward_and_the_backward(B, H, Lq, Lk, layout):
    D, item = 64, 4
    q = _views(B, H, Lq, D, layout)[0]
    _, k, v = _views(B, H, Lk, D, layout)
    args = fa._call_args(q.shape, k.shape, q.stride(), k.stride(), v.stride(), item, 1)
    assert args[:6] == (B, H, Lq, Lk, D, 1) and args[6:15] == q.stride()[:3] + k.stride()[:3] \
        + v.stride()[:3]
    # the output (the backward's o) and its gradient in [B, Lq, H, D] memory
    o_stride = (Lq * H * D, D, H * D, 1)
    s = fa._backward_strides(q.shape, k.shape, q.stride(), k.stride(), v.stride(), o_stride,
                             o_stride, item)
    assert s.dtype == np.int64 and s.shape == (24,) and not s.flags.writeable
    assert tuple(s[:9]) == args[6:15]
    assert tuple(s[9:12]) == tuple(s[12:15]) == tuple(s[15:18]) == o_stride[:3]
    assert tuple(s[18:21]) == tuple(s[21:24]) == (Lk * H * D, D, H * D)
    # the grids: the dQ pass per 64 query rows, the dK / dV pass per 64 keys
    assert B * H <= fa.GRID_Y_LIMIT and -(-max(Lq, Lk) // 64) < 2 ** 31
    # an unaligned dO row is refused by the checks the wrapper runs first
    with pytest.raises(ValueError):
        fa._backward_strides(q.shape, k.shape, q.stride(), k.stride(), v.stride(), o_stride,
                             (Lq * H * 65, 65, H * 65, 1), 2)
