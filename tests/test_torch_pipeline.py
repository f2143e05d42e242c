"""The slice as a whole: SelftokPipeline of the PyTorch port against the JAX
pipeline on the CPU. Same config, same carried seeded weights (non-zero
everywhere), same numpy images and the same numpy start noise."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu_torch.core.config import AttrDict, load_config
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from tests.torch_port_helpers import (
    TINY, assert_images_close, jax_decode as _jax_decode, pipeline_pair as _pair, to_np)

LATENT_TOL = 1e-3     # fp32 decode from identical ids through <= 6 Euler steps


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


def test_high_tier_is_taken_and_restores_the_tf32_flags(tiny, monkeypatch):
    import selftoktokenizer_tpu_torch.pipeline.pipeline as t_pipeline_mod

    tpipe, images = tiny[1], tiny[2]
    seen = []
    real = t_pipeline_mod.encoder_apply

    def spy(*a, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     kw.get("trunk_dtype"), kw.get("fast_attn")))
        return real(*a, **kw)

    monkeypatch.setattr(t_pipeline_mod, "encoder_apply", spy)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        for flags in ((False, True), (True, False)):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
            high = tpipe.encoding(images, precision="high")
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == flags
        highest = tpipe.encoding(images)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    # 'high': the fp32 trunk with TF32 on inside the call; 'highest': TF32 off
    assert seen == [(True, True, None, False)] * 2 + [(False, False, None, False)]
    # the CPU has no TF32: 'high' equals 'highest' here
    assert torch.equal(high, highest)


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
    with pytest.raises(ValueError, match="encode_precision"):
        SelftokPipeline(cfg, datasize=64, device="cpu", encode_precision="medium")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SelftokPipeline(cfg, datasize=64)          # no GPU here, no silent CPU fallback
    # int8 and the renderer are ported: both build
    pipe8 = SelftokPipeline(cfg, datasize=64, steps=2, device="cpu", decode_dtype="int8")
    assert pipe8.int8_decode and pipe8.decode_dtype == torch.bfloat16
    rcfg = cfg.to_dict()
    rcfg["tokenizer"]["params"]["model"] = "MMDiT_XL_Renderer"
    rpipe = SelftokPipeline(AttrDict(rcfg), datasize=64, device="cpu")
    assert rpipe.tcfg.decoder.renderer and hasattr(rpipe.model, "mask_token")
    with pytest.raises(ValueError, match="decoding_with_renderer"):
        rpipe.decoding(np.zeros((1, 8), np.int64))
    with pytest.raises(ValueError, match="decoding"):
        pipe8.decoding_with_renderer(np.zeros((1, 8), np.int64))
    pipe = SelftokPipeline(cfg, datasize=64, steps=2, device="cpu", encode_only=True)
    assert pipe.model is None
    for decode in (pipe.decoding, pipe.decoding_with_renderer):
        with pytest.raises(RuntimeError, match="encode_only"):
            decode(np.zeros((1, 8), np.int64))
