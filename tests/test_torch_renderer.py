"""The one-step renderer of the PyTorch port against the JAX package on the
CPU: ``renderer_apply`` in fp32 (with and without register tokens), the
two-call attention that stands for the reference's full [B,1,L,L] mask, and
``decoding_with_renderer`` through the pipeline pair in bf16 and int8.
Weights non-zero everywhere (seeded)."""

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
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
from tests.torch_port_helpers import (
    TINY, assert_images_close, jax_render, jax_tree, mmdit_tables, pipeline_pair,
    seeded_tree, to_np)

# fp32 on both sides through 2 joint blocks of width 128: summation order only
TOL = dict(rtol=1e-4, atol=1e-4)


def _renderer_cfg_dict():
    cfg = j_load_config(TINY).to_dict()
    cfg["tokenizer"]["params"]["model"] = "MMDiT_XL_Renderer"
    cfg["tokenizer"]["params"]["decoder_config"]["repeat"] = True
    return cfg


def _pair(register_length, repeat):
    jt = j_tokenizer_config(dict(j_load_config(TINY).tokenizer.params))
    tt = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    over = dict(renderer=True, repeat_mask_token=repeat, register_length=register_length)
    jcfg = dataclasses.replace(jt.decoder, **over)
    tcfg = dataclasses.replace(tt.decoder, **over)
    tree = seeded_tree(lambda k: j_mm.mmdit_init(k, jcfg), 17 + register_length,
                       mmdit_tables(jcfg))
    model = t_mm.MMDiT(tcfg)
    model.load_state_dict(convert.mmdit_state_dict(tree, tcfg), strict=True)
    return jcfg, jax_tree(tree), tcfg, model.requires_grad_(False)


@pytest.mark.parametrize("register_length,repeat", [(0, True), (2, False)])
def test_renderer_apply_fp32(register_length, repeat):
    jcfg, jp, tcfg, model = _pair(register_length, repeat)
    assert tuple(model.mask_token.shape) == (1, 1 if repeat else 16, tcfg.hidden_size)
    assert not hasattr(model, "x_embedder") and not hasattr(model, "pos_embed")
    rng = np.random.default_rng(register_length)
    ehs = rng.standard_normal((2, tcfg.K, 16)).astype(np.float32)
    mask = np.arange(tcfg.K)[None, :] <= np.array([[2], [6]])
    for m in (None, mask):
        want = j_mm.renderer_apply(jp, jcfg, jnp.asarray(ehs),
                                   mask=None if m is None else jnp.asarray(m))
        before = fa.launch_count
        got = t_mm.renderer_apply(model, tcfg, torch.from_numpy(ehs),
                                  mask=None if m is None else torch.from_numpy(m))
        assert fa.launch_count == before                 # CPU: plain versions, nothing counted
        assert tuple(got.shape) == (2, 8, 8, 16)
        np.testing.assert_allclose(to_np(got), to_np(want), **TOL)


def test_two_key_masks_equal_the_full_mask():
    # one joint block of the renderer: the reference's sdpa under the full
    # [B,1,L,L] mask (context_see_xt=False) against the port's two calls
    jcfg, jp, tcfg, model = _pair(2, True)
    rng = np.random.default_rng(5)
    B, reg, K, n_x, D = 2, 2, tcfg.K, 16, tcfg.hidden_size
    context = rng.standard_normal((B, reg + K, D)).astype(np.float32)
    x = rng.standard_normal((B, n_x, D)).astype(np.float32)
    c = rng.standard_normal((B, D)).astype(np.float32)
    tok = np.arange(K)[None, :] <= np.array([[0], [5]])
    jbp = jax.tree_util.tree_map(lambda a: a[0], jp["joint_blocks"])
    jmods = j_mm.precompute_context_mods(jp, jcfg)[0]
    tmods = t_mm.precompute_context_mods(model, tcfg)[0]
    full = j_mm.build_full_mask(jnp.asarray(tok), n_x, False, reg)
    want = j_mm.joint_block_apply(jbp, jcfg, jnp.asarray(context), jnp.asarray(x),
                                  jnp.asarray(c), pos_mods=jmods, mask=full)
    tk = torch.from_numpy(tok)
    got = t_mm.joint_block_apply(
        model.joint_blocks[0], tcfg, torch.from_numpy(context), torch.from_numpy(x),
        torch.from_numpy(c), pos_mods=tmods,
        key_mask=t_mm.build_decode_key_mask(tk, n_x, reg),
        ctx_key_mask=t_mm.build_decode_key_mask(tk, 0, reg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), to_np(w), **TOL)
    # the mask matters: context rows that saw the x keys give another answer
    seen = t_mm.joint_block_apply(
        model.joint_blocks[0], tcfg, torch.from_numpy(context), torch.from_numpy(x),
        torch.from_numpy(c), pos_mods=tmods, key_mask=t_mm.build_decode_key_mask(tk, n_x, reg))
    assert np.abs(to_np(seen[0]) - to_np(got[0])).max() > 1e-3


# bf16 decoder on both sides, and XLA and PyTorch round bf16 at different
# places (XLA may keep excess precision between fused bf16 operations), so
# the latents agree to bf16 resolution of their scale: 3e-2 of the latent
# range, a few bf16 ulps at that scale after 2 blocks. Under int8 a value
# that lies on a rounding boundary of the activation quantizer may round to
# a neighbouring level on one side only, moving a product by one weight
# step: 6e-2 of the range, with all but one value in a thousand within the
# bf16 bound.
@pytest.mark.parametrize("decode_dtype", [torch.bfloat16, "int8"])
def test_decoding_with_renderer_matches_jax(decode_dtype):
    jpipe, tpipe = pipeline_pair(_renderer_cfg_dict(), steps=1, seed=51,
                                 decode_dtype=decode_dtype)
    ids = np.random.default_rng(6).integers(0, 64, (2, 8))
    j_lat, j_img = jax_render(jpipe, ids)
    before = q8.launch_count
    t_img, t_lat = tpipe.decoding_with_renderer(ids, return_latents=True)
    assert q8.launch_count == before
    assert t_lat.dtype == torch.bfloat16 and tuple(t_img.shape) == (2, 64, 64, 3)
    assert float(t_img.min()) >= 0.0 and float(t_img.max()) <= 1.0
    quantized = sum(isinstance(m, q8.Q8Linear) for m in tpipe.model.modules())
    assert quantized == (14 if decode_dtype == "int8" else 0)
    scale = float(np.abs(j_lat).max())
    d = np.abs(to_np(t_lat) - j_lat) / scale
    print(f"{decode_dtype}: latent scale {scale:.3g}, max rel diff {d.max():.4g}, "
          f"0.999 quantile {np.quantile(d, 0.999):.4g}")
    if decode_dtype == "int8":
        # the bf16 VAE amplifies the latents' difference past the image
        # bound of identical latents: hold the VAE stage on JAX's latents
        assert np.quantile(d, 0.999) <= 3e-2 and d.max() <= 6e-2
        assert_images_close(tpipe.decode_latents(j_lat), j_img)
    else:
        assert d.max() <= 3e-2
        assert_images_close(t_img, j_img)
