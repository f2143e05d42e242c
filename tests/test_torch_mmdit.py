"""The MMDiT decoder of the PyTorch port against the JAX package, depth 2 on
the CPU in fp32, weights non-zero everywhere (adaLN included: with the
init's zero gates the attention output would never reach the result)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import mmdit as j_mm
from selftoktokenizer_tpu.models.tokenizer import (
    tokenizer_config_from_params as j_tokenizer_config)
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from tests.torch_port_helpers import jax_tree, mmdit_tables, seeded_tree, to_np

TINY = "tests/data/tiny-eval.yml"
# fp32 on both sides through 2 joint blocks of width 128: summation order only
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def mm_pair():
    jt = j_tokenizer_config(dict(j_load_config(TINY).tokenizer.params))
    tt = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    tree = seeded_tree(lambda k: j_mm.mmdit_init(k, jt.decoder), 21, mmdit_tables(jt.decoder))
    model = t_mm.MMDiT(tt.decoder)
    model.load_state_dict(convert.mmdit_state_dict(tree, tt.decoder), strict=True)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    ehs = rng.standard_normal((2, 8, 16)).astype(np.float32)
    t = np.array([0.93, 0.31], np.float32)
    return jt.decoder, jax_tree(tree), tt.decoder, model.requires_grad_(False), x, ehs, t


def test_weights_nonzero_everywhere(mm_pair):
    _, _, _, model, *_ = mm_pair
    for name, p in model.named_parameters():
        assert p.abs().sum() > 0, name
    assert any("adaLN_modulation" in n for n, _ in model.named_parameters())


def test_precompute_context_mods(mm_pair):
    jcfg, jp, tcfg, model, *_ = mm_pair
    want = j_mm.precompute_context_mods(jp, jcfg)
    got = t_mm.precompute_context_mods(model, tcfg)
    assert tuple(got.shape) == (tcfg.depth - 1, tcfg.K, 6 * tcfg.hidden_size)
    # sinusoid + two small matmuls in fp32
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


def test_mmdit_apply_partial_token_mask(mm_pair):
    jcfg, jp, tcfg, model, x, ehs, t = mm_pair
    mask = np.arange(8)[None, :] <= np.array([[2], [6]])
    want = j_mm.mmdit_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs),
                            mask=jnp.asarray(mask), context_see_xt=True)
    got = t_mm.mmdit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ehs), mask=torch.from_numpy(mask))
    assert tuple(got.shape) == (2, 8, 8, 16)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)
    # the mask matters: an all-ones mask gives another answer
    other = t_mm.mmdit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                             torch.from_numpy(ehs))
    assert (to_np(other) - to_np(got)).__abs__().max() > 1e-3


def test_mmdit_apply_sliced_context_with_precomputed_mods(mm_pair):
    jcfg, jp, tcfg, model, x, ehs, t = mm_pair
    Lc = 5
    mask = np.arange(Lc)[None, :] <= np.array([[1], [4]])
    jmods = j_mm.precompute_context_mods(jp, jcfg)
    tmods = t_mm.precompute_context_mods(model, tcfg)
    want = j_mm.mmdit_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs[:, :Lc]),
                            mask=jnp.asarray(mask), context_see_xt=True, ctx_mods=jmods)
    got = t_mm.mmdit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                           torch.from_numpy(ehs[:, :Lc]), mask=torch.from_numpy(mask),
                           ctx_mods=tmods)
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_mmdit_uncond_xonly(mm_pair):
    jcfg, jp, tcfg, model, x, _, t = mm_pair
    want = j_mm.mmdit_uncond_xonly(jp, jcfg, jnp.asarray(x), jnp.asarray(t))
    got = t_mm.mmdit_uncond_xonly(model, tcfg, torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_build_decode_key_mask(mm_pair):
    m = np.random.default_rng(1).random((2, 8)) > 0.5
    want = j_mm.build_decode_key_mask(jnp.asarray(m), 16, 0)
    got = t_mm.build_decode_key_mask(torch.from_numpy(m), 16, 0)
    np.testing.assert_array_equal(to_np(got), to_np(want))


def test_out_of_slice_entry_points_raise(mm_pair):
    _, _, tcfg, model, x, ehs, t = mm_pair
    for fn in (t_mm.mmdit_cfg_inference, t_mm.mmdit_cfg_batched):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(model, tcfg, x, t, ehs)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_mm.mmdit_apply(model, tcfg, torch.from_numpy(x), torch.from_numpy(t),
                         torch.from_numpy(ehs), context_see_xt=False)
