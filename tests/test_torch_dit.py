"""The port's DiT against the JAX package's, fp32 on the CPU at a small
size with carried seeded weights (non-zero everywhere): ``dit_apply`` (with
the label drop), ``dit_forward_with_cfg``, the cross-attention block and
the dual block in each attention mode, each within 1e-4 of the output's
scale; and the round trip of the port's state dict through the JAX
package's ``dit_from_state_dict``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.models import dit as j_dit
from selftoktokenizer_tpu.ops.posembed import sincos_2d
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import dit as t_dit
from tests.torch_port_helpers import jax_tree, seeded_tree, to_np

REL_TOL = 1e-4
# head dim 12: like XL's 72, none the attention kernel takes
CFG = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=48, depth=2, num_heads=4,
           num_classes=10)


def _rel(got, want):
    got, want = to_np(got), to_np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(seed, **kw):
    jcfg, tcfg = j_dit.DiTConfig(**{**CFG, **kw}), t_dit.DiTConfig(**{**CFG, **kw})
    tree = seeded_tree(lambda k: j_dit.dit_init(k, jcfg), seed,
                       {("pos_embed",): sincos_2d(jcfg.hidden_size, jcfg.grid)[None]})
    return jcfg, jax_tree(tree), tcfg, convert.dit_from_jax_tree(tree, tcfg)


def _inputs(B=4):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 8, 8, 4)).astype(np.float32)
    t = rng.integers(0, 1000, (B,)).astype(np.int32)
    y = rng.integers(0, 10, (B,)).astype(np.int32)
    return x, t, y


@pytest.mark.parametrize("learn_sigma", [True, False])
def test_dit_apply_matches_jax(learn_sigma):
    jcfg, jp, tcfg, model = _pair(3, learn_sigma=learn_sigma)
    x, t, y = _inputs()
    want = j_dit.dit_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = t_dit.dit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(y).long())
    assert got.shape == (4, 8, 8, 8 if learn_sigma else 4)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


def test_label_drop_takes_the_null_class():
    jcfg, jp, tcfg, model = _pair(4)
    y = np.array([1, 2, 3, 4], np.int32)
    drop = np.array([1, 0, 1, 0], np.int32)
    want = j_dit.label_embed(jp["y_embedder"], jcfg, jnp.asarray(y),
                             force_drop_ids=jnp.asarray(drop))
    got = t_dit.label_embed(model.y_embedder, tcfg, torch.from_numpy(y).long(),
                            force_drop_ids=torch.from_numpy(drop))
    np.testing.assert_array_equal(to_np(got), to_np(want))
    assert torch.equal(got[0], model.y_embedder.embedding_table.weight[tcfg.num_classes])
    assert model.y_embedder.embedding_table.weight.shape[0] == tcfg.num_classes + 1
    # training draws come from the generator: the same seed, the same drop
    gen = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (t_dit.label_embed(model.y_embedder, tcfg, torch.from_numpy(y).long(), train=True,
                              rng=g) for g in gen)
    assert torch.equal(a, b)


def test_dit_forward_with_cfg_matches_jax():
    jcfg, jp, tcfg, model = _pair(5)
    x, t, _ = _inputs()
    y = np.array([3, 7, 10, 10], np.int32)            # conditional half, then the null class
    want = j_dit.dit_forward_with_cfg(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y),
                                      4.0)
    with torch.no_grad():
        got = t_dit.dit_forward_with_cfg(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                                         torch.from_numpy(y).long(), 4.0)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)
    # the guided first 3 channels are equal across the halves, the rest are not
    assert torch.equal(got[:2, ..., :3], got[2:, ..., :3])
    assert not torch.equal(got[:2, ..., 3:], got[2:, ..., 3:])


def test_dit_state_dict_round_trip():
    jcfg, _, tcfg, model = _pair(6)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jp = jax_tree(j_dit.dit_from_state_dict(sd, jcfg))
    x, t, y = _inputs()
    want = j_dit.dit_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = t_dit.dit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                              torch.from_numpy(y).long())
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


@pytest.mark.parametrize("cross_modulate", [True, False])
def test_cross_attn_block_matches_jax(cross_modulate):
    D, E, H = 48, 24, 4
    tree = seeded_tree(lambda k: j_dit.dit_cross_attn_block_init(
        k, D, E, H, cross_modulate=cross_modulate), 7)
    block = convert.dit_cross_attn_block_from_jax_tree(tree, D, E, H)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, D)).astype(np.float32)
    c = rng.standard_normal((2, D)).astype(np.float32)
    ehs = rng.standard_normal((2, 6, E)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    want = j_dit.dit_cross_attn_block_apply(jax_tree(tree), H, jnp.asarray(x), jnp.asarray(c),
                                            jnp.asarray(ehs), jnp.asarray(mask))
    with torch.no_grad():
        got = t_dit.dit_cross_attn_block_apply(block, H, torch.from_numpy(x), torch.from_numpy(c),
                                               torch.from_numpy(ehs), torch.from_numpy(mask))
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


@pytest.mark.parametrize("mode", ["bi", "uni", "uni-0"])
def test_dual_block_matches_jax(mode):
    # 'bi' modulates the q stream from t_emb, so its q_dim is the hidden size
    Dq = 48 if mode == "bi" else 32
    kw = dict(hidden_size=48, q_dim=Dq, num_heads=4, query_heads=4, dit_attention=mode)
    jcfg, tcfg = j_dit.DiTDualConfig(**kw), t_dit.DiTDualConfig(**kw)
    tree = seeded_tree(lambda k: j_dit.dit_dual_block_init(k, jcfg), 9)
    if "gate" in tree["attn"]:
        tree["attn"]["gate"] = 30.0 * tree["attn"]["gate"]    # tanh(gate) far from 0
    block = convert.dit_dual_block_from_jax_tree(tree, tcfg)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 16, 48)).astype(np.float32)
    q = rng.standard_normal((2, 6, Dq)).astype(np.float32)
    t_emb = rng.standard_normal((2, 48)).astype(np.float32)
    t_emb_q = rng.standard_normal((2, Dq)).astype(np.float32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    wx, wq = j_dit.dit_dual_block_apply(jax_tree(tree), jcfg, jnp.asarray(x), jnp.asarray(t_emb),
                                        jnp.asarray(t_emb_q), jnp.asarray(q),
                                        mask=jnp.asarray(mask))
    with torch.no_grad():
        gx, gq = t_dit.dit_dual_block_apply(block, tcfg, torch.from_numpy(x),
                                            torch.from_numpy(t_emb), torch.from_numpy(t_emb_q),
                                            torch.from_numpy(q), mask=torch.from_numpy(mask))
    assert _rel(gx, wx) <= REL_TOL, _rel(gx, wx)
    assert _rel(gq, wq) <= REL_TOL, _rel(gq, wq)


def test_dit_xl_configs():
    cfg = t_dit.DiTConfig(**t_dit.DIT_CONFIGS["DiT-XL/2"])
    assert (cfg.depth, cfg.hidden_size // cfg.num_heads, cfg.out_channels) == (28, 72, 8)
    assert t_dit.DIT_CONFIGS == j_dit.DIT_CONFIGS
