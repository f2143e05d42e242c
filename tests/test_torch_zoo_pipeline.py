"""The zoo's configurations through the port's entry points on the CPU,
against the JAX package: a reference ``.pth`` of a non-dual encoder and
the variant decoder (qk-norm 'ln', 'pos_t_emb', mean pooling) written by
the JAX exporter; the variant decoder with register tokens decoding at cfg
1.0 and 2.0 (the unconditional branch then ``mmdit_cfg_inference``, with
``uncond_y`` from a file); and the flagship's other public configurations,
K = 1024 tokens and 512 px, at a cut depth."""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.core import export as j_export
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, AttrDict
from selftoktokenizer_tpu_torch.models import encoder as t_enc
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from tests.torch_port_helpers import (
    TINY, add_ln_qk_norm, encoder_tables, jax_decode, jax_tree, mmdit_tables, pipeline_pair,
    seeded_tree, to_np)

LATENT_TOL = 1e-3     # fp32 decode from identical ids through a few Euler steps
# fp32 encode from identical latents: (pre-VQ features relative to their
# scale, top-2 margin below which ids may differ); the flagship family's 6
# blocks over 1024 queries take the rule of tests/test_torch_encoder.py
SMALL_ENC_TOL = (1e-5, 1e-6)
FLAGSHIP_ENC_TOL = (1e-4, 1e-5)


def _variant_cfg(tmp_path, enc="Enc-Qformer-Uni-M/2", mode="concat"):
    """The tiny config with a non-dual encoder and the variant decoder, its
    uncond_y written with torch.save from a seeded tensor."""
    cfg = j_load_config(TINY).to_dict()
    p = cfg["tokenizer"]["params"]
    p["enc"] = enc
    p["encoder_config"]["qformer_mode"] = mode
    path = tmp_path / "uncond_y.pt"
    torch.save(torch.from_numpy(np.random.default_rng(3).standard_normal(128)
                                .astype(np.float32)), path)
    p["decoder_config"].update(qk_norm="ln", time_adaln="pos_t_emb", sd3_cond_pooling="mean",
                               uncond_y_file=str(path))
    return cfg


def _ln_hook(tree, tc):
    add_ln_qk_norm(tree["model"], tc.decoder, 9)


def test_pth_of_concat_encoder_and_variant_decoder_loads(tmp_path):
    """A .pth from the JAX exporter (``tokenizer_to_state_dict``) of a seeded
    tree loads into the port's pipeline with every leaf equal. The exporter
    writes qk-norm leaves only for 'rms': the 'ln' ones are added under the
    reference's names (``attn.ln_q.weight`` / ``.bias``)."""
    cfg = _variant_cfg(tmp_path)
    jtc = j_tok.tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 51, tables)
    _ln_hook(tree, jtc)
    sd = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in j_export.tokenizer_to_state_dict(tree, jtc).items()}
    tcfg = t_tok.tokenizer_config_from_params(dict(cfg["tokenizer"]["params"]))
    want = convert.tokenizer_state_dict(tree, tcfg)
    ln = {k: v for k, v in want.items() if ".attn.ln_" in k}
    assert ln and not set(ln) & set(sd)
    sd.update(ln)
    torch.save({"state_dict": sd}, tmp_path / "tok.pth")
    pipe = SelftokPipeline(AttrDict(cfg), ckpt_path=str(tmp_path / "tok.pth"), datasize=64,
                           steps=2, device="cpu")
    assert pipe.tcfg.encoder.qformer_mode == "concat"
    got = {"encoder." + k: v for k, v in pipe.encoder.state_dict().items()}
    got.update({"model." + k: v for k, v in pipe.model.state_dict().items()})
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    torch.testing.assert_close(pipe.model.uncond_y,
                               torch.load(tmp_path / "uncond_y.pt", weights_only=True))
    # the loaded encoder equals the JAX one on identical latents
    x = np.random.default_rng(4).standard_normal((2, 8, 8, 16)).astype(np.float32)
    _assert_ids(pipe.encoder, pipe.tcfg.encoder, jax_tree(tree["encoder"]), jtc.encoder, x)


def _assert_ids(enc, tcfg, jp, jcfg, x, tol=SMALL_ENC_TOL):
    """ids of the port's and the JAX encoder on identical fp32 latents:
    the quantizer inputs within tol[0] of their scale, ids equal outside a
    top-2 margin of tol[1]."""
    d = np.zeros(x.shape[0], np.int32)
    got = t_enc.encoder_apply(enc, tcfg, torch.from_numpy(x), d=torch.from_numpy(d))
    want = j_enc.encoder_apply(jp, jcfg, jnp.asarray(x), d=jnp.asarray(d))
    g_outs, g_ids = to_np(got[1]), to_np(got[6])
    w_outs, w_ids = to_np(want[1]), to_np(want[6])
    assert np.abs(g_outs - w_outs).max() <= tol[0] * np.abs(w_outs).max()
    # the margins of the JAX quantizer input just computed
    _, margins = j_vq.vq_margins(jp["quantizer"], want[1])
    diff = g_ids != w_ids
    assert not (diff & (to_np(margins) >= tol[1])).any(), int(diff.sum())
    return g_ids


def _with_registers(build, n):
    def wrapped(*a, **kw):
        return dataclasses.replace(build(*a, **kw), register_length=n)
    return wrapped


@pytest.fixture(scope="module")
def variant_registers(tmp_path_factory):
    """The variant decoder with 4 register tokens: the decoder config takes
    no register_length from a yml, so both packages' tokenizer configs get
    it here."""
    import selftoktokenizer_tpu.models.tokenizer as j_tok_mod
    import selftoktokenizer_tpu_torch.models.tokenizer as t_tok_mod

    cfg = _variant_cfg(tmp_path_factory.mktemp("reg"))
    with mock.patch.object(j_tok_mod, "build_decoder_config",
                           _with_registers(j_tok_mod.build_decoder_config, 4)), \
            mock.patch.object(t_tok_mod, "build_decoder_config",
                              _with_registers(t_tok_mod.build_decoder_config, 4)):
        jpipe, tpipe = pipeline_pair(cfg, steps=3, seed=52, tree_hook=_ln_hook)
    assert tpipe.tcfg.decoder.register_length == jpipe.tcfg.decoder.register_length == 4
    return jpipe, tpipe


@pytest.mark.parametrize("cfg_scale", [1.0, 2.0])
def test_variant_decoder_with_registers_decodes_as_jax(variant_registers, cfg_scale):
    jpipe, tpipe = variant_registers
    assert tpipe.model.uncond_y is not None and "uncond_y" in jpipe.params["model"]
    rng = np.random.default_rng(53)
    ids = rng.integers(0, 64, (2, 8))
    noise = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    j_lat, _ = jax_decode(jpipe, ids, noise, cfg_scale, images=False)
    _, t_lat = tpipe.decoding(ids, noise=noise, cfg_scale=cfg_scale, return_latents=True)
    np.testing.assert_allclose(to_np(t_lat), j_lat, rtol=LATENT_TOL, atol=LATENT_TOL)


def _flagship_cut(k):
    """The flagship config at K tokens with its encoder family cut to
    Enc-Qformer-Uni-S/2 (6 blocks, query width 128) and its decoder to
    depth 2: the tokens, positions, codebook and sampler are the
    flagship's."""
    cfg = j_load_config(FLAGSHIP_CONFIG).to_dict()
    p = cfg["tokenizer"]["params"]
    p["enc"] = "Enc-Qformer-Uni-S/2"
    p["decoder_config"]["depth"] = 2
    if k == 1024:
        p["k"] = p["quantizer_config"]["K"] = 1024
        p["k_per_stage"] = "384,368,144,96,32"      # as bench.py sets it
    return cfg


@pytest.mark.parametrize("k, datasize", [(1024, 256), (512, 512)], ids=["k1024", "512px"])
def test_flagship_public_configurations_match_jax(k, datasize, monkeypatch):
    cfg = _flagship_cut(k)
    jpipe, tpipe = pipeline_pair(cfg, steps=2, seed=54, datasize=datasize)
    assert tpipe.K == k and tpipe.tcfg.encoder.codebook_size == 32768
    np.testing.assert_array_equal(tpipe.step_k, jpipe.step_k)
    assert tpipe._decode_segments() == jpipe._decode_segments()
    latent = datasize // 8
    rng = np.random.default_rng(55)
    x = rng.standard_normal((1, latent, latent, 16)).astype(np.float32)
    ids = _assert_ids(tpipe.encoder, tpipe.tcfg.encoder, jpipe.params["encoder"],
                      jpipe.tcfg.encoder, x, FLAGSHIP_ENC_TOL)
    assert ids.shape == (1, k)
    noise = rng.standard_normal((1, latent, latent, 16)).astype(np.float32)
    j_lat, _ = jax_decode(jpipe, ids, noise, images=False)
    lengths = []
    real = t_mm.serving_attention

    def spy(q, k_, v, key_mask=None):
        lengths.append(q.shape[2])
        return real(q, k_, v, key_mask)

    monkeypatch.setattr(t_mm, "serving_attention", spy)
    _, t_lat = tpipe.decoding(ids, noise=noise, return_latents=True)
    np.testing.assert_allclose(to_np(t_lat), j_lat, rtol=LATENT_TOL, atol=LATENT_TOL)
    # the joint attention's longest rows: K context rows and (latent / 2)^2
    # x rows (1536 at 512 px)
    assert max(lengths) == k + (latent // 2) ** 2
