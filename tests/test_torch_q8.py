"""The int8 side of the PyTorch port against the JAX package on the CPU:
the weight quantizer, the choice of the linears that are quantized, the
plain version beside the ``q8_matmul`` CUDA kernel against the Pallas
kernel in interpret mode, and ``q8_linear`` against the reference's XLA
emulation.

Every comparison is bit for bit: both sides round at the same steps (per-row
scale in fp32, IEEE division, round half to even, an exact integer product,
one rounding of it to fp32, two fp32 products, one rounding to x's type, the
bias added in x's type). The reference's scale divides by the constant 127,
which XLA turns into a product with its fp32 reciprocal in every compiled
program; its emulation is therefore compared jitted, as the decode runs it."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import mmdit as j_mm
from selftoktokenizer_tpu.models.tokenizer import (
    tokenizer_config_from_params as j_tokenizer_config)
from selftoktokenizer_tpu.ops import q8_matmul as j_q8
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
from selftoktokenizer_tpu_torch.ops.linear import linear_apply
from tests.torch_port_helpers import TINY, jax_tree, mmdit_tables, seeded_tree, to_np


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def bits(a):
    """Exact comparison key: the float32 values of either framework's array."""
    return to_np(a).astype(np.float32)


def test_quantize_weight_equals_reference_with_a_zero_channel():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((3, 96, 80)) * 0.05).astype(np.float32)    # [.., in, out]
    w[1, :, 7] = 0.0                                                     # s_w clamps to 1e-8
    w[2, :, 0] = 1e-12                                                   # below the clamp
    jq, js = j_q8.quantize_weight(w)
    tq, ts = q8.quantize_weight(T(np.swapaxes(w, -1, -2)))               # [.., out, in]
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(tq.numpy(), -1, -2), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert ts[1, 7] == np.float32(1e-8) and not tq[1, 7].any()


def _tree_and_model(jcfg, tcfg, seed, dtype=torch.bfloat16):
    tree = seeded_tree(lambda k: j_mm.mmdit_init(k, jcfg), seed, mmdit_tables(jcfg))
    model = t_mm.MMDiT(tcfg)
    model.load_state_dict(convert.mmdit_state_dict(tree, tcfg), strict=True)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), jax_tree(tree))
    return jp, model.requires_grad_(False).to(dtype)


def _port_name(path, depth):
    """The port module name of a linear in the reference's parameter tree."""
    if path[0] == "joint_blocks":           # stacked blocks: one name per entry
        return [f"joint_blocks.{i}." + ".".join(_tail(path[1:]))
                for i in range(depth - 1)]
    if path[0] == "last_block":
        return [f"joint_blocks.{depth - 1}." + ".".join(_tail(path[1:]))]
    return [".".join(path)]


def _tail(path):
    return [("attn." + p) if p in ("qkv", "proj") else p for p in path]


def _quantized_paths(tree, path=()):
    if isinstance(tree, dict):
        if "w_q" in tree:
            return [path]
        return [p for k, v in tree.items() for p in _quantized_paths(v, path + (k,))]
    return []


@pytest.mark.parametrize("case", ["tiny", "stacked_size_rule"])
def test_module_selection_and_weights_equal_quantize_params_tree(case):
    jt = j_tokenizer_config(dict(j_load_config(TINY).tokenizer.params))
    tt = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    jcfg, tcfg, min_size = jt.decoder, tt.decoder, q8.MIN_SIZE
    if case == "stacked_size_rule":
        # width 64, depth 4, a higher threshold: a qkv of a stacked block is
        # judged by 3 x 12288 and quantized, the last block's qkv by 12288
        # and not; proj (3 x 4096) is not either
        jcfg = dataclasses.replace(jcfg, depth=4, hidden_override=64, context_dim=64)
        tcfg = dataclasses.replace(tcfg, depth=4, hidden_override=64, context_dim=64)
        min_size = 2 ** 14
    jp, model = _tree_and_model(jcfg, tcfg, seed=3)
    jq = j_q8.quantize_params_tree(jp, min_size=min_size)
    q8.quantize_model_(model, min_size=min_size)

    want = {n: p for p in _quantized_paths(jq) for n in _port_name(p, tcfg.depth)}
    got = {n for n, m in model.named_modules() if isinstance(m, q8.Q8Linear)}
    assert got == set(want), (sorted(got ^ set(want)))
    for name, path in want.items():
        node = jq
        for k in path:
            node = node[k]
        i = int(name.split(".")[1]) if path[0] == "joint_blocks" else None
        wq, sw = (np.asarray(node["w_q"]), np.asarray(node["s_w"]))
        if i is not None:
            wq, sw = wq[i], sw[i]
        m = model.get_submodule(name)
        np.testing.assert_array_equal(m.weight_q.numpy(), wq.T, err_msg=name)
        np.testing.assert_array_equal(m.s_w.numpy(), sw, err_msg=name)
        assert m.s_w.dtype == torch.float32 and m.bias.dtype == torch.bfloat16
    if case == "tiny":
        # hidden 128: context_embedder [16,128] stays bf16, final_layer.linear
        # [128,64] is quantized; adaLN and the embedders never are
        assert isinstance(model.context_embedder, torch.nn.Linear)
        assert isinstance(model.final_layer.linear, q8.Q8Linear)
        assert len(got) == 8 * (tcfg.depth - 1) + 5 + 1
    else:
        assert f"joint_blocks.0.context_block.attn.qkv" in got
        assert f"joint_blocks.3.x_block.attn.qkv" not in got
        assert "joint_blocks.0.x_block.attn.proj" not in got


def test_cast_keeps_scales_fp32_and_moves_them():
    m = q8.Q8Linear.from_linear(torch.nn.Linear(40, 24))
    sw = m.s_w.clone()
    m.to(torch.bfloat16)
    assert m.s_w.dtype == torch.float32 and torch.equal(m.s_w, sw)
    assert m.weight_q.dtype == torch.int8 and m.bias.dtype == torch.bfloat16
    m.half().float()
    assert torch.equal(m.s_w, sw) and "s_w" in dict(m.named_buffers())


def _x(seed, M, K, kind="normal"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    if kind == "edge":
        x[0] = 0.0                       # all-zero row: scale 1e-8, output = bias
        x[1] = 1e-3 * x[1]
        x[1, 5] = 300.0                  # one large value: the rest quantize to 0
    return x


# (M, K, N): the Pallas kernel pads M to 256 and N to its 512 blocks, so
# ragged M, N = 768 (a remainder column block, as tests/test_regressions.py
# pins) and K = 16 (the context embedder) are each a case; K = 37 pads the
# quantized rows to 48, K = 1536 is the decode's
SHAPES = [(77, 128, 768), (256, 16, 512), (300, 200, 500), (33, 37, 70), (64, 1536, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_q8_matmul_plain_equals_pallas_interpret(M, K, N, dtype):
    rng = np.random.default_rng(M + K + N)
    x = _x(M, M, K, "edge")
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    wq, sw = j_q8.quantize_weight(w)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_q8.q8_matmul(jnp.asarray(x, jd), jnp.asarray(wq), jnp.asarray(sw),
                          interpret=True, out_dtype=jd)
    got = q8.q8_matmul_plain(T(x, td), T(wq.T), T(sw))
    assert got.dtype == td and tuple(got.shape) == (M, N)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert not to_np(got)[0].any()
    # the kernel's two stages: quantize each row once, then the product
    xq, sx = q8.q8_quantize_rows_plain(T(x, td))
    assert xq.dtype == torch.int8 and tuple(xq.shape) == (M, q8.padded_k(K))
    assert not xq[:, K:].any()
    two = q8.q8_matmul_quantized_plain(xq, sx, T(wq.T), T(sw), dtype=td)
    np.testing.assert_array_equal(bits(two), bits(want))


@pytest.mark.parametrize("bias_dtype", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SHAPES)
def test_quantize_then_product_equals_q8_matmul_plain(M, K, N, dtype, bias_dtype):
    rng = np.random.default_rng(M * K + N)
    x = _x(M + 1, M, K, "edge")
    x[2, K - 1] = 50.0                   # a row whose maximum lies in its last K tile
    w = (rng.standard_normal((N, K)) * K ** -0.5).astype(np.float32)
    td = getattr(torch, dtype)
    wq, sw = q8.quantize_weight(T(w))
    b = None if bias_dtype is None else T(rng.standard_normal(N) * 0.02, getattr(torch, bias_dtype))
    xq, sx = q8.q8_quantize_rows(T(x, td))           # a CPU tensor: the plain version
    assert sx.dtype == torch.float32 and tuple(sx.shape) == (M,)
    assert int(xq[2, K - 1]) == 127 and float(sx[0]) == np.float32(1e-8)
    got = q8.q8_matmul_quantized_plain(xq, sx, wq, sw, b, dtype=td)
    want = q8.q8_matmul_plain(T(x, td), wq, sw, b)
    assert got.dtype == want.dtype == td
    np.testing.assert_array_equal(bits(got), bits(want))


# the int8 decode's products (batch 2: x stream M = 512, context M = 2 x its
# bucket's length, up to 1024; the renderer at batch 8), then ragged ones
PLAN_SHAPES = [
    (512, 1536, 4608), (512, 1536, 1536), (512, 1536, 6144), (512, 6144, 1536),
    (1024, 1536, 4608), (1024, 1536, 1536), (1024, 1536, 6144), (1024, 6144, 1536),
    (1024, 16, 1536), (512, 1536, 64), (256, 1536, 4608), (768, 6144, 1536),
    (2048, 1536, 4608), (4096, 6144, 1536), (4096, 16, 1536),
    (300, 200, 500), (33, 37, 70), (1, 16, 8), (129, 4097, 193),
]
# forced plans: K splits that do not divide the K tiles evenly, the widest
# split, the narrow and wide tiles
FORCED_PLANS = [(256, 1280, 256, 128, 4), (512, 6144, 1536, 192, 5), (512, 1536, 64, 64, 12),
                (33, 37, 70, 192, 1), (300, 4000, 500, 64, 7), (200, 200, 500, 144, 1),
                (200, 1536, 333, 96, 5)]


def _plans():
    for M, K, N in PLAN_SHAPES:
        for item in (2, 4):
            yield pytest.param(q8.plan_q8(M, K, N, item), id=f"{M}x{K}x{N}-{item}B")
    for M, K, N, bn, splits in FORCED_PLANS:
        yield pytest.param(q8.Q8Plan(M, K, N, bn, splits), id=f"{M}x{K}x{N}-bn{bn}-split{splits}")


@pytest.mark.parametrize("plan", list(_plans()))
def test_plan_covers_every_output_and_k_tile_once(plan):
    M, K, N, bn, splits = plan.M, plan.K, plan.N, plan.bn, plan.splits
    # K padding: rows of a 16-byte multiple, less than one step past K
    assert plan.Kp % 16 == 0 and K <= plan.Kp < K + 16
    assert (plan.k_tiles - 1) * q8.BK < plan.Kp <= plan.k_tiles * q8.BK
    # the tiles cover M x N exactly once, and none lies wholly outside
    cover = np.zeros((M, N), np.int32)
    for i in range(plan.tiles_m):
        for j in range(plan.tiles_n):
            assert i * q8.BM < M and j * bn < N
            cover[i * q8.BM:(i + 1) * q8.BM, j * bn:(j + 1) * bn] += 1
    assert (cover == 1).all()
    # the splits cover every K tile exactly once, each at least one
    ranges = [plan.k_range(s) for s in range(splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.k_tiles
    assert all(a < b for a, b in ranges)
    assert all(ranges[s][1] == ranges[s + 1][0] for s in range(splits - 1))
    assert max(b - a for a, b in ranges) - min(b - a for a, b in ranges) <= 1
    # scratch: xq, sx, counters, partials, 256-byte aligned and disjoint
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.n_counters == (tiles if splits > 1 else 0)
    assert plan.partial_bytes == (splits * tiles * q8.BM * bn * 4 if splits > 1 else 0)
    offs = [0, plan.sx_offset, plan.counters_offset, plan.partials_offset]
    sizes = [M * plan.Kp, 4 * M, 4 * plan.n_counters, plan.partial_bytes]
    assert all(o % 256 == 0 for o in offs)
    assert all(offs[i] + sizes[i] <= offs[i + 1] for i in range(3))
    assert plan.scratch_bytes == offs[3] + sizes[3]
    # the card's limits
    assert bn in q8.BNS and bn % 8 == 0 and 1 <= splits <= min(plan.k_tiles, 65535)
    assert plan.tiles_m < 2 ** 31 and plan.tiles_n <= q8.GRID_YZ_LIMIT
    assert q8.smem_bytes(bn) <= q8.SMEM_LIMIT and q8.THREADS <= 1024
    assert plan.grid == (plan.tiles_m, plan.tiles_n, splits)


def test_planner_splits_k_where_the_tiles_leave_the_card_idle():
    # the x stream's fc2 (K = 6144) has 48 tiles of 128 x 128 for 132 SMs and
    # 48 K tiles each: its K is split
    fc2 = q8.plan_q8(512, 6144, 1536)
    assert fc2.splits > 1 and fc2.tiles_m * fc2.tiles_n * fc2.splits <= q8.SMS
    # the final linear (N = 64) takes one 64-wide tile column
    assert q8.plan_q8(512, 1536, 64).bn == 64
    # a shape that fills the card many times over is not split
    assert q8.plan_q8(4096, 1536, 6144).splits == 1
    with pytest.raises(ValueError):
        q8.plan_q8(0, 16, 16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_dtype", ["float32", "bfloat16"])
def test_q8_linear_equals_reference_emulation(dtype, bias_dtype):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 37, 96)).astype(np.float32)
    x[1, 3] = 0.0
    w = (rng.standard_normal((96, 768)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(768) * 0.02).astype(np.float32)
    wq, sw = j_q8.quantize_weight(w)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jb, tb = getattr(jnp, bias_dtype), getattr(torch, bias_dtype)
    want = jax.jit(j_q8.q8_linear)({"w_q": jnp.asarray(wq), "s_w": jnp.asarray(sw),
                                    "b": jnp.asarray(b, jb)}, jnp.asarray(x, jd))
    m = q8.Q8Linear(T(wq.T), T(sw), T(b, tb))
    got = linear_apply(m, T(x, td))
    assert got.dtype == td and tuple(got.shape) == (2, 37, 768)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert torch.equal(got, q8.q8_linear(m, T(x, td), plain=True))


def test_cpu_tensor_takes_the_plain_version_without_counting():
    x = T(_x(5, 33, 64), torch.bfloat16)
    wq, sw = q8.quantize_weight(torch.randn(48, 64, generator=torch.Generator().manual_seed(0)))
    b = torch.zeros(48, dtype=torch.bfloat16)
    before = q8.launch_count
    assert torch.equal(q8.q8_matmul(x, wq, sw, b), q8.q8_matmul_plain(x, wq, sw, b))
    assert q8.launch_count == before


def test_q8_matmul_raises_on_what_the_kernel_does_not_take():
    x = torch.randn(4, 32)
    wq, sw = q8.quantize_weight(torch.randn(8, 32))
    with pytest.raises(ValueError):
        q8.q8_matmul(x, wq.float(), sw)                 # weights must be int8
    with pytest.raises(ValueError):
        q8.q8_matmul(x[:, :16], wq, sw)                 # K mismatch
    with pytest.raises(ValueError):
        q8.q8_matmul(x, wq, sw, torch.zeros(7))         # bias length
    with pytest.raises(ValueError):
        q8.q8_matmul(x.half(), wq, sw)                  # fp16 is not a decode type
