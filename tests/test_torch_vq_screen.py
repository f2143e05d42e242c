"""The design of the port's ``vq_argmax`` kernel, checked on the CPU: its
host planner, the bound on its TF32 screen, and its interval rule, emulated
in the kernel's code order with its split boundaries, against the plain
version and the Pallas kernel in interpret mode.

The CUDA kernel itself cannot run here; chip_smoke.py holds it against the
plain version and the float64 argmax on the card. The emulation rounds the
operands to TF32 as ``cvt.rna.tf32.f32`` does (to nearest, ties away from
zero, on the fp32 bit pattern) and E as the tensor core reads fp32 bits
(the low 13 bits dropped), and models the tensor core's fp32
accumulation two ways: rounded once to nearest, and truncated toward zero
after every term in the mma's k order. The exact score is the kernel's chain
of 16 fp32 fused multiply-adds, each taken in float64 and rounded to fp32
(a double rounding that can differ from one fma only on exact fp32 ties)."""

import math
import os
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.ops.vq_kernels import vq_argmax as j_vq_argmax
from selftoktokenizer_tpu_torch.ops import vq_kernels as vk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "selftoktokenizer_tpu_torch", "csrc", "vq_argmax.cu")

# the kernel's k order: k-step t of its wgmma takes d = 8t .. 8t + 7
K_STEPS = (list(range(8)), list(range(8, 16)))


def tf32_rna(a):
    """cvt.rna.tf32.f32 on fp32 values: keep 10 mantissa bits, round to
    nearest with ties away from zero (add half of the dropped part to the
    magnitude bits)."""
    bits = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x1000) & 0xFFFFE000
    return bits.astype(np.uint32).view(np.float32)


def tf32_trunc(a):
    """fp32 bits read as TF32: the low 13 bits dropped."""
    bits = np.asarray(a, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def to_f32_rz(x):
    """float64 -> fp32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def exact_chain(z, e):
    """[N, C] fp32: s = fma(z[d], e[d], s) for d = 0..15, from s = 0."""
    z64, e64 = z.astype(np.float64), e.astype(np.float64)
    s = np.zeros((z.shape[0], e.shape[0]), np.float32)
    for d in range(z.shape[1]):
        s = (np.outer(z64[:, d], e64[:, d]) + s.astype(np.float64)).astype(np.float32)
    return s


def screens(z, e):
    """The two models of the TF32 screen, [N, C] fp32 each."""
    a = tf32_rna(z).astype(np.float64)
    b = tf32_trunc(e).astype(np.float64)
    once = (a @ b.T).astype(np.float32)
    acc = np.zeros((z.shape[0], e.shape[0]), np.float32)
    for ks in K_STEPS:
        for d in ks:
            acc = to_f32_rz(acc.astype(np.float64) + np.outer(a[:, d], b[:, d]))
    return once, acc


def eps(z, e):
    """The kernel's bound on |screen - exact score|, float64 [N, C]:
    K_EPS * ||z|| * ||e||, each norm floored at NORM_FLOOR (the kernel rounds
    every factor up, and takes the tile's largest ||e||, so its own bound is
    at least this)."""
    nz = np.maximum(np.linalg.norm(z.astype(np.float64), axis=1), vk.NORM_FLOOR)
    ne = np.maximum(np.linalg.norm(e.astype(np.float64), axis=1), vk.NORM_FLOOR)
    return vk.K_EPS * nz[:, None] * ne[None, :]


def better(s, c, best, arg):
    return (s > best) | ((s == best) & (c < arg))


def emulate_kernel(z, e, plan, screen):
    """The kernel's selection, in its order: per split, per 128-code tile
    (the codes past C staged as copies of code C-1), the lower bound
    L = max(L, M - kz * nmax) from the tile's largest screen M, then every
    code whose screen reaches T = L - kz * nmax is scored exactly, each lane
    of the row its own codes 8j + 2q + {0, 1} in ascending order (each exact
    score raises L). Returns (ids, re-scored codes per row)."""
    N, C = z.shape[0], e.shape[0]
    ex = exact_chain(z, e).astype(np.float64)
    nz = np.maximum(np.linalg.norm(z.astype(np.float64), axis=1), vk.NORM_FLOOR)
    ne = np.maximum(np.linalg.norm(e.astype(np.float64), axis=1), vk.NORM_FLOOR)
    kz = vk.K_EPS * nz
    sc = screen.astype(np.float64)
    cnt = np.zeros(N, np.int64)
    best_s, best_a = np.full(N, -np.inf), np.zeros(N, np.int64)
    for split in range(plan.splits):
        start, stop = plan.code_range(split)
        L = np.full(N, -np.inf)
        lb, la = np.full((N, 4), -np.inf), np.full((N, 4), start, np.int64)
        for t0 in range(start, stop, vk.TILE_C):
            cols = np.minimum(np.arange(t0, t0 + vk.TILE_C), C - 1)
            nmax = ne[cols].max()
            L = np.maximum(L, sc[:, cols].max(axis=1) - kz * nmax)
            T = L - kz * nmax                       # as at the tile's start: a superset
            Lq = np.repeat(L[:, None], 4, axis=1)
            for q in range(4):
                for c in (t0 + 8 * j + 2 * q + o for j in range(vk.TILE_C // 8) for o in range(2)):
                    if c >= C:
                        continue
                    hit = sc[:, c] >= T
                    s = ex[:, c]
                    cnt += hit
                    Lq[:, q] = np.where(hit, np.maximum(Lq[:, q], s), Lq[:, q])
                    win = hit & better(s, c, lb[:, q], la[:, q])
                    lb[:, q] = np.where(win, s, lb[:, q])
                    la[:, q] = np.where(win, c, la[:, q])
            L = Lq.max(axis=1)
        for q in range(4):        # the lanes, then the splits in ascending order
            win = better(lb[:, q], la[:, q], best_s, best_a) | (split == 0) & (q == 0)
            best_s = np.where(win, lb[:, q], best_s)
            best_a = np.where(win, la[:, q], best_a)
    return best_a.astype(np.int32), cnt


def exact_argmax(z, e):
    return np.argmax(exact_chain(z, e), axis=1).astype(np.int32)


def rows_with_norms(rng, n, lo=0.1, hi=10.0, d=16):
    a = rng.standard_normal((n, d)).astype(np.float32)
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    return (a * np.exp(rng.uniform(np.log(lo), np.log(hi), (n, 1)))).astype(np.float32)


def unit_rows(rng, n, d=16):
    return rows_with_norms(rng, n, 1.0, 1.0, d)


def near_tie_book(rng, z, C):
    """A random codebook where, for each of the first C // 2 rows of z, the
    best code gets a twin whose score is 1e-6..1e-3 below it (z unit-norm):
    beyond the smoke test's 1e-6 margin, inside the TF32 window."""
    e = unit_rows(rng, C)
    ids = np.argmax(z.astype(np.float64) @ e.astype(np.float64).T, axis=1)
    for n in range(min(z.shape[0], C // 2)):
        twin = (n * 7919) % C
        if twin == ids[n]:
            continue
        delta = 10.0 ** rng.uniform(-6, -3)
        e[twin] = (e[ids[n]] - delta * z[n]).astype(np.float32)
    return e


# ------------------------------------------------------------------ planner ---

@pytest.mark.parametrize("N,C", [(4096, 32768), (16384, 32768), (512, 32768), (1000, 5001),
                                 (1, 1), (129, 300), (4096, 8192), (32768, 32768)])
def test_plan_vq_covers_every_code_once_in_ascending_splits(N, C):
    plan = vk.plan_vq(N, C)
    assert 1 <= plan.splits <= min(plan.c_tiles, vk.MAX_SPLITS)
    ranges = [plan.code_range(s) for s in range(plan.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(a < b for a, b in ranges)                 # no empty split
    assert all(a % vk.TILE_C == 0 for a, _ in ranges)    # splits start on a staged tile
    assert plan.grid == (math.ceil(N / vk.ROWS), plan.splits)
    if plan.splits > 1:
        assert plan.arg_offset % 256 == 0 and plan.scratch_bytes % 256 == 0
        assert plan.arg_offset >= 4 * plan.tiles_n * plan.splits * vk.ROWS
    else:
        assert plan.scratch_bytes == 0


def test_plan_vq_fills_the_card_at_the_flagship():
    # one full wave of RESIDENT blocks on every SM: 128 of 132 SMs at both
    # batch sizes, and not one block into a second wave
    for N, splits in ((4096, 8), (16384, 2)):
        plan = vk.plan_vq(N, 32768)
        assert plan.splits == splits
        blocks = plan.tiles_n * plan.splits
        assert 0.95 * vk.SMS * vk.RESIDENT <= blocks <= vk.SMS * vk.RESIDENT
    with pytest.raises(ValueError):
        vk.plan_vq(0, 32768)


@pytest.mark.parametrize("N,C,splits", [(1000, 5001, 20), (512, 32768, 64), (32768, 32768, 1),
                                        (129, 300, 3)])
def test_plan_vq_stays_in_one_wave_with_even_splits(N, C, splits):
    # 33 splits of 40 tiles would leave most splits one tile and some two:
    # 20 splits of 2 tiles take as long in fewer blocks
    plan = vk.plan_vq(N, C)
    assert plan.splits == splits
    assert plan.tiles_n * plan.splits <= max(vk.SMS * vk.RESIDENT, plan.tiles_n)
    sizes = {b - a for a, b in (plan.code_range(s) for s in range(plan.splits))}
    assert max(sizes) - min(sizes) <= vk.TILE_C


def test_split_counters_are_kept_per_device_and_stream():
    # two streams never share arrival counters; one stream keeps its own
    # (zeroed once, grown when a launch needs more row tiles)
    vk._counters.clear()
    a = vk._counters_for(torch.device("cpu"), 1, 10)
    b = vk._counters_for(torch.device("cpu"), 2, 10)
    assert a.data_ptr() != b.data_ptr() and int(a.abs().sum()) == 0
    assert vk._counters_for(torch.device("cpu"), 1, 1024) is a
    big = vk._counters_for(torch.device("cpu"), 1, 5000)
    assert big.numel() >= 5000 and int(big.abs().sum()) == 0
    assert vk._counters_for(torch.device("cpu"), 2, 10) is b
    vk._counters.clear()


def test_kernel_constants_match_the_source():
    src = open(SRC).read()

    def const(name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    assert int(eval(const("ROWS").replace("WGS", const("WGS")))) == vk.ROWS
    assert int(const("TILE_C")) == vk.TILE_C
    assert eval(const("K_EPS").replace("f", "")) == vk.K_EPS
    assert np.float32(float(const("NORM_FLOOR").rstrip("f"))) == np.float32(vk.NORM_FLOOR)
    # the proof's sum: z rounded and E truncated, tensor-core allowance, exact chain
    v, u = 2.0 ** -11, 2.0 ** -24
    need = (3 * v + 2 * v * v) + vk.TC_ACC_REL * (1 + v) * (1 + 2 * v) + 16 * u / (1 - 16 * u)
    assert need < vk.K_EPS < 1.1 * need


# -------------------------------------------------------------- the bound ---

@pytest.mark.parametrize("case", ["unit", "norms_0.1_10", "near_tie", "large_n"])
def test_screen_error_within_the_stated_bound(case):
    rng = np.random.default_rng({"unit": 0, "norms_0.1_10": 1, "near_tie": 2, "large_n": 3}[case])
    if case == "unit":
        z, e = unit_rows(rng, 256), unit_rows(rng, 2048)
    elif case == "norms_0.1_10":
        z, e = rows_with_norms(rng, 256), rows_with_norms(rng, 2048)
    elif case == "near_tie":
        z = unit_rows(rng, 256)
        e = near_tie_book(rng, z, 2048)
    else:
        z, e = rows_with_norms(rng, 4096), rows_with_norms(rng, 512)
    ex = exact_chain(z, e).astype(np.float64)
    ep = eps(z, e)
    for sc in screens(z, e):
        err = np.abs(sc.astype(np.float64) - ex)
        assert (err <= ep).all(), float((err / ep).max())
        # the bound is not slack by orders of magnitude: TF32 rounding shows
        assert (err / ep).max() > 0.01


def test_screen_bound_covers_the_operand_rounding_alone_with_the_allowance_to_spare():
    rng = np.random.default_rng(4)
    z, e = rows_with_norms(rng, 128), rows_with_norms(rng, 1024)
    once, _ = screens(z, e)
    t = z.astype(np.float64) @ e.astype(np.float64).T
    nz = np.linalg.norm(z.astype(np.float64), axis=1)[:, None]
    ne = np.linalg.norm(e.astype(np.float64), axis=1)[None, :]
    v = 2.0 ** -11
    assert (np.abs(once - t) <= (3 * v + 2 * v * v) * nz * ne + 2.0 ** -24 * np.abs(t) + 1e-30).all()
    # truncating E is what the allowance for it is for: rounding it would do with 2v
    assert tf32_trunc(e).view(np.uint32).tolist() != tf32_rna(e).view(np.uint32).tolist()


# -------------------------------------------------------- the interval rule ---

def _check_rule(z, e, splits=None, pallas=True, margin=1e-6):
    plan = vk.VQPlan(z.shape[0], e.shape[0], splits) if splits else vk.plan_vq(*z.shape[:1], e.shape[0])
    want = exact_argmax(z, e)
    plain = vk.vq_argmax_plain(torch.from_numpy(z), torch.from_numpy(e)).numpy()
    s64 = np.sort(z.astype(np.float64) @ e.astype(np.float64).T, axis=1)
    wide = (s64[:, -1] - s64[:, -2]) >= margin
    counts = []
    for screen in screens(z, e):
        got, cnt = emulate_kernel(z, e, plan, screen)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got[wide], plain[wide])
        counts.append(cnt)
    if pallas:
        jp = np.asarray(j_vq_argmax(jnp.asarray(z), jnp.asarray(e), interpret=True))
        np.testing.assert_array_equal(want[wide], jp[wide])
    return counts


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_interval_rule_keeps_the_exact_argmax_random_unit(splits):
    rng = np.random.default_rng(10 + splits)
    z, e = unit_rows(rng, 96), unit_rows(rng, 4096)
    counts = _check_rule(z, e, splits)
    # a handful of exact scores per row and split, not the whole codebook
    tiles = 4096 // vk.TILE_C // splits
    assert counts[0].mean() <= 4 * splits * (math.log(tiles) + 1)


def test_interval_rule_keeps_the_exact_argmax_non_unit_norms_and_ragged_c():
    rng = np.random.default_rng(20)
    z, e = rows_with_norms(rng, 77), rows_with_norms(rng, 1000)
    _check_rule(z, e, 3, pallas=False)


def test_interval_rule_keeps_the_exact_argmax_near_ties():
    rng = np.random.default_rng(21)
    z = unit_rows(rng, 64)
    e = near_tie_book(rng, z, 4096)
    _check_rule(z, e, 4)


def test_interval_rule_identical_codes_give_id_zero_and_rescore_every_code():
    rng = np.random.default_rng(22)
    z = unit_rows(rng, 40)
    e = np.repeat(unit_rows(rng, 1), 4096, axis=0)
    for cnt in _check_rule(z, e, 8):
        assert (cnt == 4096).all()
    assert not exact_argmax(z, e).any()


def test_interval_rule_duplicate_codes_give_the_lowest_id():
    rng = np.random.default_rng(23)
    z = unit_rows(rng, 64)
    base = unit_rows(rng, 2048)
    e = np.concatenate([base, base])
    _check_rule(z, e, 5)
    assert exact_argmax(z, e).max() < 2048
