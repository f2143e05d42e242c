"""The slice as a whole: SelftokPipeline of the PyTorch port against the JAX
pipeline on the CPU. Same config, same carried seeded weights (non-zero
everywhere), same numpy images and the same numpy start noise."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import AttrDict as JAttrDict
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu.pipeline import SelftokPipeline as JaxPipeline
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import AttrDict, load_config
from selftoktokenizer_tpu_torch.models.vae import VAEConfig
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from tests.torch_port_helpers import (
    encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

TINY = "tests/data/tiny-eval.yml"
LATENT_TOL = 1e-3     # fp32 decode from identical ids through <= 6 Euler steps


def assert_images_close(got, want):
    """The VAE decodes in bf16 on both sides, and XLA and PyTorch round at
    different places: each side's bf16 image lies up to 0.035 from its own
    fp32 image with these weights, single pixels further. So: within 5e-2
    for all but one pixel value in a thousand, and none beyond 1e-1."""
    d = np.abs(to_np(got) - to_np(want))
    assert np.quantile(d, 0.999) <= 5e-2 and d.max() <= 1e-1, (np.quantile(d, 0.999), d.max())


def _pair(cfg_dict, steps, seed):
    """(jax pipeline, port pipeline) with one set of seeded weights and a
    narrow VAE (ch=32) on both sides."""
    import functools
    from unittest import mock

    import selftoktokenizer_tpu.pipeline.pipeline as j_pipeline_mod
    from selftoktokenizer_tpu.models.mmdit import precompute_context_mods
    from selftoktokenizer_tpu.models.tokenizer import tokenizer_init

    def zeros_like_init(init_fn):
        # the JAX constructor draws random weights that are replaced below:
        # give it zero trees of the right shapes, which cost no compile
        def fn(key, cfg, *a, **kw):
            shapes = jax.eval_shape(lambda k: init_fn(k, cfg, *a, **kw), key)
            return jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return fn

    # the JAX pipeline builds VAEConfig() itself: hand it the narrow one
    with mock.patch.object(j_pipeline_mod, "VAEConfig",
                           functools.partial(j_vae.VAEConfig, ch=32)), \
            mock.patch.object(j_pipeline_mod, "tokenizer_init", zeros_like_init(tokenizer_init)), \
            mock.patch.object(j_pipeline_mod, "vae_init", zeros_like_init(j_vae.vae_init)):
        jpipe = JaxPipeline(JAttrDict(cfg_dict), datasize=64, steps=steps)
    assert jpipe.vae_cfg.ch == 32
    tc = jpipe.tcfg
    vae_tree = seeded_tree(lambda k: j_vae.vae_init(k, jpipe.vae_cfg), seed)
    tok_tree = seeded_tree(
        lambda k: tokenizer_init(k, tc), seed + 1,
        {**encoder_tables(tc.encoder, ("encoder",)), **mmdit_tables(tc.decoder, ("model",))})
    jpipe.vae_params = jax_tree(vae_tree)
    jpipe.params = jax_tree(tok_tree)
    jpipe._ctx_mods = precompute_context_mods(jpipe.params["model"], tc.decoder)

    tpipe = SelftokPipeline(AttrDict(cfg_dict), datasize=64, steps=steps, device="cpu")
    tpipe.set_weights(convert.tokenizer_from_jax_tree(tok_tree, tpipe.tcfg),
                      convert.vae_from_jax_tree(vae_tree, VAEConfig(ch=32)))
    return jpipe, tpipe


def _jax_decode(jpipe, ids, noise, cfg_scale=None):
    """(latents, images) of the JAX pipeline for given start noise: its
    jitted decode with the final VAE step taken off, then its own
    decode_latents."""
    keep = jpipe._latents_to_images
    jpipe._latents_to_images = lambda vp, x: x
    try:
        fn = jax.jit(jpipe._decode_impl, static_argnames=("cfg_scale",))
        lat = fn(jpipe.params, jpipe._ctx_mods, jpipe.vae_params, jnp.asarray(ids),
                 jnp.asarray(noise), cfg_scale=cfg_scale)
        lat = jax.block_until_ready(lat)
    finally:
        jpipe._latents_to_images = keep
    return to_np(lat), to_np(jpipe.decode_latents(lat))


@pytest.fixture(scope="module")
def tiny():
    cfg = j_load_config(TINY).to_dict()
    jpipe, tpipe = _pair(cfg, steps=4, seed=31)
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    j_ids, j_marg = (to_np(a) for a in jpipe.encoding_margins(images))
    return jpipe, tpipe, images, noise, j_ids, j_marg


def test_port_config_loader_matches(tiny):
    assert load_config(TINY).to_dict() == j_load_config(TINY).to_dict()
    jpipe, tpipe, *_ = tiny
    np.testing.assert_array_equal(tpipe.step_k, jpipe.step_k)
    assert tpipe._decode_segments() == jpipe._decode_segments()


def test_encode_ids_under_the_margin_rule(tiny):
    jpipe, tpipe, images, _, j_ids, j_marg = tiny
    t_ids = to_np(tpipe.encoding(images))
    # the images go through the VAE in bf16, where XLA and PyTorch round
    # differently, so the latents differ (measured and printed below) and
    # with them every cosine score. An id can flip only where the top-2
    # margin is smaller than the shift of that gap between the two sides,
    # so ids must be equal wherever the JAX margin exceeds twice the largest
    # measured shift of the margins, and at least 0.05
    j_lat = to_np(j_vae.vae_encode_mode(jpipe.vae_params, jpipe.vae_cfg,
                                        jnp.asarray(images, jnp.bfloat16)))
    t_lat = to_np(tpipe._images_to_latents(torch.from_numpy(images)) / 1.5305 + 0.0609)
    lat_diff = float(np.abs(j_lat - t_lat).max())
    t_marg = to_np(tpipe.encoding_margins(images)[1])
    same = t_ids == j_ids
    thr = max(0.05, 2.0 * float(np.abs(t_marg - j_marg)[same].max()))
    safe = j_marg > thr
    print(f"latent max diff {lat_diff:.4g} (latent scale {np.abs(j_lat).max():.3g}), "
          f"margin threshold {thr:.4g}, share of tokens above it {safe.mean():.3f}, "
          f"ids equal overall {same.mean():.3f}")
    assert t_ids.dtype == np.int32 and t_ids.shape == (4, 8)
    assert safe.mean() >= 0.25
    np.testing.assert_array_equal(t_ids[safe], j_ids[safe])
    # the 'default' tier runs (bf16 trunk, plain kernel versions on the CPU)
    assert to_np(tpipe.encoding(images, precision="default")).shape == (4, 8)


@pytest.mark.parametrize("case", ["cfg1", "cfg2", "truncated"])
def test_decode_fp32_from_identical_ids(tiny, case):
    jpipe, tpipe, _, noise, j_ids, _ = tiny
    ids = j_ids[:2]
    cfg_scale = 2.0 if case == "cfg2" else None
    if case == "truncated":
        ids = ids[:, :5]
    j_lat, j_img = _jax_decode(jpipe, ids, noise, cfg_scale)
    t_img, t_lat = tpipe.decoding(ids, noise=noise, cfg_scale=cfg_scale, return_latents=True)
    assert tuple(t_img.shape) == (2, 64, 64, 3)
    assert float(t_img.min()) >= 0.0 and float(t_img.max()) <= 1.0
    np.testing.assert_allclose(to_np(t_lat), j_lat, rtol=LATENT_TOL, atol=LATENT_TOL)
    assert_images_close(t_img, j_img)
    assert_images_close(tpipe.decode_latents(j_lat), j_img)


def test_decode_noise_from_generator_is_reproducible(tiny):
    tpipe = tiny[1]
    ids = np.zeros((1, 8), np.int64)
    g = torch.Generator().manual_seed(5)
    a = tpipe.decoding(ids, generator=g)
    b = tpipe.decoding(ids, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and torch.equal(tpipe.decoding(ids), tpipe.decoding(ids))


def test_k256_bucketed_decode_equals_single_loop_and_jax():
    cfg = j_load_config(TINY).to_dict()
    p = cfg["tokenizer"]["params"]
    p["k"] = 256
    p["k_per_stage"] = "96,92,36,24,8"
    p["quantizer_config"]["K"] = 256
    jpipe, tpipe = _pair(cfg, steps=6, seed=41)
    segs = tpipe._decode_segments()
    assert segs is not None and len(segs) > 1 and segs == jpipe._decode_segments()
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 64, (1, 256))
    noise = rng.standard_normal((1, 8, 8, 16)).astype(np.float32)
    _, bucketed = tpipe.decoding(ids, noise=noise, return_latents=True)
    tpipe._decode_segments = lambda: None
    _, single = tpipe.decoding(ids, noise=noise, return_latents=True)
    # masked tokens contribute exactly 0, so slicing them off changes only
    # the summation order of the attention
    np.testing.assert_allclose(to_np(bucketed), to_np(single), rtol=1e-5, atol=1e-5)
    j_lat, _ = _jax_decode(jpipe, ids, noise)
    np.testing.assert_allclose(to_np(bucketed), j_lat, rtol=LATENT_TOL, atol=LATENT_TOL)


def test_entry_points_raise_for_what_is_not_ported():
    cfg = load_config(TINY)
    for kw in (dict(ckpt_path="x.pth"), dict(decode_dtype="int8"),
               dict(encode_precision="high")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            SelftokPipeline(cfg, datasize=64, device="cpu", **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SelftokPipeline(cfg, datasize=64)          # no GPU here, no silent CPU fallback
    pipe = SelftokPipeline(cfg, datasize=64, steps=2, device="cpu", encode_only=True)
    assert pipe.model is None
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        pipe.decoding_with_renderer(np.zeros((1, 8), np.int64))
