"""The plain reference against the port, on the CPU: the weight layout at the
flagship sizes, the sampler's step table and buckets, and the encode, the
decode and the renderer at a tiny configuration, the port in fp32."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark.harness import port, spec, traffic, weights
from benchmark.harness.serving import vae_image_rel, worst_pooled_rel, worst_relative_rms
from benchmark.reference import encoder as ref_enc
from benchmark.reference import mmdit as ref_mmdit
from benchmark.reference import vae as ref_vae
from benchmark.tests.helpers import tiny_config

CONFIGS = ["flagship-256", "flagship-renderer-256"]
SEED = 2 ** 31 + 12345


def _config(name):
    with open(os.path.join(spec.HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_layout_is_the_port_s(name):
    """The benchmark's leaves are the port's state dict, name for name and
    shape for shape, tokenizer and VAE."""
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        ImageTokenizer, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig
    cfg = _config(name)
    with torch.device("meta"):
        tok = ImageTokenizer(tokenizer_config_from_params(cfg["tokenizer_params"]))
        vae = SDVAE(VAEConfig(ch=cfg["vae"]["ch"]))
    spec_tok = {n: tuple(s) for n, s, _ in weights.encoder_spec(cfg["encoder"])
                + weights.decoder_spec(cfg["decoder"], cfg["K"])}
    assert spec_tok == {k: tuple(v.shape) for k, v in tok.state_dict().items()}
    assert {n: tuple(s) for n, s, _ in weights.vae_spec(cfg["vae"])} == \
        {k: tuple(v.shape) for k, v in vae.state_dict().items()}


@pytest.mark.parametrize("name", CONFIGS)
def test_config_widths_are_the_port_s(name):
    """The widths the reference reads equal the port's parsed configuration."""
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    cfg = _config(name)
    t = tokenizer_config_from_params(cfg["tokenizer_params"])
    e, d = cfg["encoder"], cfg["decoder"]
    for key in ("K", "patch_size", "hidden_size", "num_heads", "depth", "query_dim",
                "query_heads", "pos_embed_max_size", "code_dim", "codebook_size",
                "input_size", "in_channels", "encoder_hidden_size"):
        assert getattr(t.encoder, key) == e[key], key
    for key in ("depth", "hidden_size", "num_heads", "patch_size", "pos_embed_max_size",
                "num_patches", "context_dim", "renderer", "input_size"):
        assert getattr(t.decoder, key) == d[key], key
    assert t.k == cfg["K"] and t.image_size == cfg["image_size"]


def test_step_table_and_buckets_are_the_pipeline_s():
    from selftoktokenizer_tpu_torch.models import flow
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.pipeline.pipeline import SelftokPipeline
    cfg = _config("flagship-256")
    tcfg = tokenizer_config_from_params(cfg["tokenizer_params"])
    sched = flow.make_schedule(cfg["decode_steps"], 1.0, "uniform", shift=1.0)
    theirs = flow.precompute_step_k(tcfg.make_diti(), sched, t2k=tcfg.t2k)
    t_now, t_prev, tm = ref_mmdit.schedule(cfg["decode_steps"])
    ours = ref_mmdit.step_tokens(cfg["diti"], cfg["K"], tm)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(t_now, sched["scheduled_t"])
    np.testing.assert_array_equal(t_prev, sched["scheduled_t_prev"])
    segments = SelftokPipeline._decode_segments(types.SimpleNamespace(K=cfg["K"], step_k=theirs))
    assert ref_mmdit.buckets(ours, cfg["K"]) == segments


def _pipe_and_weights(renderer=False, dtype="float32", encode_only=False):
    cfg = tiny_config(renderer)
    pipe = port.pipeline(cfg, SEED, "cpu", dtype=dtype, encode_only=encode_only)
    sd = weights.tokenizer_weights(cfg, SEED, "cpu",
                                   decoder=None if encode_only else weights.decoder_dtype(dtype))
    return cfg, pipe, sd, weights.vae_weights(cfg, SEED, "cpu")


def test_encode_ids_equal_the_port_s():
    cfg, pipe, sd, vsd = _pipe_and_weights(encode_only=True)
    images = traffic.make({"inputs": "images", "batch": 4, "pool": 1}, cfg, SEED, "cpu")[0]
    ids = pipe.encoding(images["images"])
    with torch.no_grad():
        lat = ref_vae.images_to_latents(vsd, images["images"], torch.bfloat16)
        ref_ids, margins = ref_enc.encode(sd, cfg["encoder"], lat)
        assert torch.equal(lat, pipe._images_to_latents(images["images"]))
    assert torch.equal(ids.long(), ref_ids)
    assert float(margins.min()) > 0


def test_decode_latents_equal_the_port_s_fp32():
    cfg, pipe, sd, vsd = _pipe_and_weights()
    b = traffic.make({"inputs": "ids", "batch": 2, "pool": 1, "noise": True}, cfg, SEED, "cpu")[0]
    images, latents = pipe.decoding(b["ids"], noise=b["noise"], return_latents=True)
    with torch.no_grad():
        ref = ref_mmdit.sample(sd, cfg["decoder"], cfg["diti"], cfg["K"], cfg["decode_steps"],
                               ref_enc.context(sd, b["ids"]), b["noise"])
        img = ref_vae.latents_to_images(vsd, latents, torch.bfloat16)
    assert float((latents - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    assert torch.equal(images, img)


def test_render_latents_equal_the_port_s_fp32():
    cfg, pipe, sd, vsd = _pipe_and_weights(renderer=True)
    b = traffic.make({"inputs": "ids", "batch": 2, "pool": 1}, cfg, SEED, "cpu")[0]
    images, latents = pipe.decoding_with_renderer(b["ids"], return_latents=True)
    with torch.no_grad():
        ref = ref_mmdit.render(sd, cfg["decoder"], ref_enc.context(sd, b["ids"]))
        img = ref_vae.latents_to_images(vsd, latents, torch.bfloat16)
    assert float((latents - ref).abs().max()) < 1e-5 * float(ref.abs().max())
    assert torch.equal(images, img)


def test_vae_stage_reads_the_fp8_control_above_the_program():
    """``vae_image_rel``: the port's bf16 VAE against the reference's fp32
    one reads well under the reference's own VAE with float8 convolutions
    in its place; the fp8 rounding keeps a tensor's scale and leaves 3
    mantissa bits."""
    cfg, pipe, sd, vsd = _pipe_and_weights()
    b = traffic.make({"inputs": "ids", "batch": 2, "pool": 1, "noise": True}, cfg, SEED, "cpu")[0]
    images, latents = pipe.decoding(b["ids"], noise=b["noise"], return_latents=True)
    with torch.no_grad():
        program = vae_image_rel(vsd, latents, images)
        control = vae_image_rel(vsd, latents, images, fp8_control=True)
    assert 0 < program and 3 * program < control
    t = torch.tensor([448.0, 1.0, 1.0625, -3.3])
    assert torch.equal(ref_vae.fp8(t), torch.tensor([448.0, 1.0, 1.0, -3.25]))


def test_pooled_latent_gap():
    """Window 1 is the full-resolution gap; over a latent that is smooth
    across a window, a wider window averages white noise down and keeps an
    offset whole."""
    g = torch.Generator().manual_seed(5)
    ref = torch.randn(2, 2, 2, 16, generator=g).repeat_interleave(4, 1).repeat_interleave(4, 2)
    noise = 0.01 * torch.randn(2, 8, 8, 16, generator=g)
    assert worst_pooled_rel(ref + noise, ref, 1) == pytest.approx(
        worst_relative_rms(ref + noise, ref))
    assert worst_pooled_rel(ref + noise, ref, 4) < 0.5 * worst_pooled_rel(ref + noise, ref, 1)
    assert worst_pooled_rel(ref + 0.01, ref, 4) == pytest.approx(
        worst_relative_rms(ref + 0.01, ref), rel=1e-4)


def test_buckets_change_nothing():
    """Cutting the masked context to its bucket leaves the velocity as it
    is (masked keys weigh 0)."""
    cfg = tiny_config()
    sd = weights.tokenizer_weights(cfg, SEED, "cpu", decoder=torch.float32)
    d = cfg["decoder"]
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 8, 8, 16, generator=g)
    ehs = torch.randn(2, cfg["K"], 16, generator=g)
    mods = ref_mmdit.context_mods(sd, d, cfg["K"])
    t = torch.full((2,), 0.5)
    mask = torch.arange(cfg["K"])[None].expand(2, -1) <= 3
    full = ref_mmdit.velocity(sd, d, x, t, ehs, mask, mods)
    cut = ref_mmdit.velocity(sd, d, x, t, ehs[:, :4], mask[:, :4], mods)
    assert float((full - cut).abs().max()) < 1e-5
