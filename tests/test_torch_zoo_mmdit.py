"""The MMDiT options of the PyTorch port beyond the flagship's (qk-norm 'ln',
the 'pos_t_emb' adaLN, pooled conditioning with the unconditional buffers,
register tokens under CFG, the batched CFG trunk, RenderDiT) against the
JAX package, depth 2 on the CPU in fp32 with carried seeded weights,
non-zero everywhere. The unconditional buffers are read on both sides from
one ``torch.save``d file."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core import convert as j_cv
from selftoktokenizer_tpu.models import mmdit as j_mm
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import flow as t_flow
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from tests.torch_port_helpers import add_ln_qk_norm, jax_tree, mmdit_tables, seeded_tree, to_np

# fp32 on both sides through 2 joint blocks of width 128: summation order
# only, held relative to the output's largest magnitude
REL_TOL = 1e-5
# the same function of the port computed over B rows and over 2B rows
BATCHED_REL_TOL = 1e-6

BASE = dict(depth=2, K=8, patch_size=2, in_channels=16, pos_embed_max_size=16,
            num_patches=256, encoder_hidden_size=16, context_dim=128, adm_in_channels=16,
            time_adaln="pos_emb")
VARIANT = dict(qk_norm="ln", time_adaln="pos_t_emb", sd3_cond_pooling="mean")


def _rel(got, want):
    got, want = to_np(got), to_np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _build(seed, tmp_path=None, **kw):
    """(jax cfg, jax params, port cfg, port module). With tmp_path the
    unconditional buffer uncond_y [hidden] is written there with torch.save
    and named in the config; each side loads it by its own loader."""
    kw = {**BASE, **kw}
    rng = np.random.default_rng(seed + 1000)
    if tmp_path is not None:
        hidden = 64 * kw["depth"]
        torch.save(torch.from_numpy(rng.standard_normal(hidden).astype(np.float32)),
                   tmp_path / "uncond_y.pt")
        kw["uncond_y_file"] = str(tmp_path / "uncond_y.pt")
    jcfg, tcfg = j_mm.MMDiTConfig(**kw), t_mm.MMDiTConfig(**kw)
    tree = seeded_tree(lambda k: j_mm.mmdit_init(k, jcfg), seed, mmdit_tables(jcfg))
    if jcfg.qk_norm == "ln":
        add_ln_qk_norm(tree, jcfg, seed)
    model = t_mm.MMDiT(tcfg)
    model.load_state_dict(convert.mmdit_state_dict(tree, tcfg), strict=True)
    model.set_uncond_buffers(t_mm.load_uncond_buffers(tcfg))
    jp = jax_tree(tree)
    jp.update(jax_tree(j_cv.load_uncond_buffers(jcfg)))
    return jcfg, jp, tcfg, model.requires_grad_(False)


def _inputs(B=2, K=8, seed=8, size=8):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, size, size, 16)).astype(np.float32)
    ehs = rng.standard_normal((B, K, 16)).astype(np.float32)
    t = np.array([0.93, 0.31, 0.5, 0.7][:B], np.float32)
    mask = np.arange(K)[None, :] <= np.array([[2], [6], [7], [0]][:B])
    return x, ehs, t, mask


J, T = jnp.asarray, torch.from_numpy


@pytest.mark.parametrize("opts", [dict(qk_norm="ln"), dict(time_adaln="pos_t_emb"), VARIANT],
                         ids=["qk_norm_ln", "pos_t_emb", "variant"])
def test_mmdit_option_matches_jax(opts):
    jcfg, jp, tcfg, model = _build(31, **opts)
    x, ehs, t, mask = _inputs()
    jmods = j_mm.precompute_context_mods(jp, jcfg)
    tmods = t_mm.precompute_context_mods(model, tcfg)
    if tcfg.time_adaln == "pos_t_emb":
        assert tuple(tmods.shape) == (1, tcfg.K, tcfg.hidden_size)
    assert _rel(tmods, jmods) <= REL_TOL
    want = j_mm.mmdit_apply(jp, jcfg, J(x), J(t), J(ehs), mask=J(mask), context_see_xt=True,
                            ctx_mods=jmods)
    got = t_mm.mmdit_apply(model, tcfg, T(x), T(t), T(ehs), mask=T(mask), ctx_mods=tmods)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)
    # the option is live: the flagship's settings give another answer
    plain = dataclasses.replace(tcfg, qk_norm=None, time_adaln="pos_emb") \
        if tcfg.qk_norm == "ln" else dataclasses.replace(tcfg, time_adaln="t_emb")
    other = t_mm.mmdit_apply(model, plain, T(x), T(t), T(ehs), mask=T(mask))
    assert _rel(other, want) > 1e-3


@pytest.mark.parametrize("case", ["pooled_last_cond", "pooled_mean_cond", "uncond_y",
                                  "registers_uncond", "registers_variant_uncond"])
def test_cfg_inference_matches_jax(case, tmp_path):
    """The unconditional branch (encoder_hidden_states None, the sampler's
    zero mask) and its conditional form (pooled y of the given states),
    with uncond_y read from a torch.save'd file, and with
    register tokens, whose keys stay active."""
    kw = {"pooled_last_cond": dict(sd3_cond_pooling="last"),
          "pooled_mean_cond": dict(sd3_cond_pooling="mean"),
          "uncond_y": dict(sd3_cond_pooling="mean"),
          "registers_uncond": dict(register_length=4, sd3_cond_pooling="last"),
          "registers_variant_uncond": dict(register_length=4, **VARIANT)}[case]
    jcfg, jp, tcfg, model = _build(32, tmp_path, **kw)
    assert "uncond_y" in jp and model.uncond_y is not None
    x, ehs, t, mask = _inputs()
    cond = case.endswith("_cond")
    e = ehs * mask[..., None] if cond else None
    m = mask if cond else np.zeros_like(mask)
    jm = j_mm.precompute_context_mods(jp, jcfg)
    tm = t_mm.precompute_context_mods(model, tcfg)
    want = j_mm.mmdit_cfg_inference(jp, jcfg, J(x), J(t), None if e is None else J(e),
                                    mask=J(m), ctx_mods=jm)
    got = t_mm.mmdit_cfg_inference(model, tcfg, T(x), T(t), None if e is None else T(e),
                                   mask=T(m), ctx_mods=tm)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)
    if tcfg.register_length:
        # the registers reach the output (a sign flip: a constant shift would
        # vanish in the blocks' LayerNorm)
        with torch.no_grad():
            model.register.neg_()
        moved = t_mm.mmdit_cfg_inference(model, tcfg, T(x), T(t), None, mask=T(m), ctx_mods=tm)
        assert _rel(moved, want) > 1e-4


@pytest.mark.parametrize("opts", [dict(), dict(**VARIANT)], ids=["flagship", "variant"])
def test_cfg_batched_matches_jax_and_sequential(opts, tmp_path):
    """Both CFG branches in one 2B trunk: against the JAX function, and
    against the port's own two calls (mmdit_apply, never pooled, and
    mmdit_cfg_inference with every context key masked)."""
    jcfg, jp, tcfg, model = _build(33, tmp_path, **opts)
    x, ehs, t, mask = _inputs()
    jv_c, jv_u = j_mm.mmdit_cfg_batched(jp, jcfg, J(x), J(t), J(ehs), J(mask))
    v_c, v_u = t_mm.mmdit_cfg_batched(model, tcfg, T(x), T(t), T(ehs), T(mask))
    assert _rel(v_c, jv_c) <= REL_TOL and _rel(v_u, jv_u) <= REL_TOL
    s_c = t_mm.mmdit_apply(model, tcfg, T(x), T(t), T(ehs), mask=T(mask))
    s_u = t_mm.mmdit_cfg_inference(model, tcfg, T(x), T(t), None,
                                   mask=torch.zeros_like(T(mask)))
    assert _rel(v_c, s_c) <= BATCHED_REL_TOL, _rel(v_c, s_c)
    assert _rel(v_u, s_u) <= BATCHED_REL_TOL, _rel(v_u, s_u)
    # the x-only branch equals the full unconditional one (no registers)
    xo = t_mm.mmdit_uncond_xonly(model, tcfg, T(x), T(t))
    assert _rel(xo, s_u) <= BATCHED_REL_TOL, _rel(xo, s_u)
    with pytest.raises(ValueError, match="register"):
        t_mm.mmdit_cfg_batched(model, dataclasses.replace(tcfg, register_length=4), T(x), T(t),
                               T(ehs), T(mask))


def test_sampler_pair_call_equals_two_calls(tmp_path):
    """p_sample_loop's cfg_pair_fn (one mmdit_cfg_batched a step) against
    its uncond_fn / model_fn pair, over 3 steps at cfg 2.0."""
    _, _, tcfg, model = _build(34, tmp_path, **VARIANT)
    x, ehs, _, _ = _inputs()
    sched = t_flow.make_schedule(3)
    step_k = np.array([7, 4, 2], np.int32)
    kw = dict(step_k=step_k, K=tcfg.K, cfg_scale=2.0)
    pair = t_flow.p_sample_loop(
        None, sched, T(x), T(ehs),
        cfg_pair_fn=lambda x_, t_, e, m: t_mm.mmdit_cfg_batched(model, tcfg, x_, t_, e, m), **kw)
    two = t_flow.p_sample_loop(
        lambda x_, t_, e, m: t_mm.mmdit_apply(model, tcfg, x_, t_, e, mask=m), sched, T(x), T(ehs),
        uncond_fn=lambda x_, t_, e, m: t_mm.mmdit_uncond_xonly(model, tcfg, x_, t_), **kw)
    assert _rel(pair, two) <= BATCHED_REL_TOL, _rel(pair, two)


@pytest.mark.parametrize("opts", [dict(register_length=4, sd3_cond_pooling="mean"),
                                  dict(sd3_cond_pooling="last", repeat_mask_token=True)],
                         ids=["registers_mean_pooled", "last_pooled_one_mask_token"])
def test_renderdit_matches_jax(opts):
    """RenderDiT: a fixed 16 x 16 mask-token grid at t = 1000, one key mask
    with identical rows over [registers | tokens | mask tokens]."""
    jcfg, jp, tcfg, model = _build(35, renderer=True, input_size=32, **opts)
    _, ehs, _, mask = _inputs()
    x_mask = np.ones((2, 256), bool)
    x_mask[1, 200:] = False
    want = j_mm.renderdit_apply(jp, jcfg, J(ehs), mask=J(mask), x_mask=J(x_mask))
    got = t_mm.renderdit_apply(model, tcfg, T(ehs), mask=T(mask), x_mask=T(x_mask))
    assert tuple(got.shape) == (2, 32, 32, 16)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)
    # the token mask and the pooled conditioning matter
    full = t_mm.renderdit_apply(model, tcfg, T(ehs), x_mask=T(x_mask))
    assert _rel(full, want) > 1e-4
