"""DiTi maps, the VQ and the Qformer encoder of the PyTorch port against the
JAX package, on the CPU at a small size with carried seeded weights."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import diti as j_diti
from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import flow as j_flow
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.models.tokenizer import (
    tokenizer_config_from_params as j_tokenizer_config)
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.models import diti as t_diti
from selftoktokenizer_tpu_torch.models import encoder as t_enc
from selftoktokenizer_tpu_torch.models import flow as t_flow
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models import vq as t_vq
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, tokenizer_config_from_params)
from tests.torch_port_helpers import encoder_tables, jax_tree, seeded_tree, to_np

TINY = "tests/data/tiny-eval.yml"


# ------------------------------------------------------------------ diti --

def test_diti_tables_equal():
    stages, kps = "200,400,600,800,1000", "192,184,72,48,16"
    t = np.concatenate([np.arange(0, 1001, dtype=np.float32),
                        np.linspace(0, 1000, 777, dtype=np.float32)])
    for jcls, tcls in ((j_diti.DiTiCont, t_diti.DiTiCont), (j_diti.DiTi, t_diti.DiTi)):
        want = np.asarray(jcls(1000, 512, stages, kps).to_indices(jnp.asarray(t)))
        got = tcls(1000, 512, stages, kps).to_indices(torch.from_numpy(t)).numpy()
        np.testing.assert_array_equal(got, want)
    tn = np.linspace(0.01, 0.99, 99, dtype=np.float32)
    want = np.asarray(j_diti.DiTiNormal(1000, 512, 0.0, 1.0).to_indices(jnp.asarray(tn)))
    got = t_diti.DiTiNormal(1000, 512, 0.0, 1.0).to_indices(torch.from_numpy(tn)).numpy()
    # ceil(K * Phi(.)) in fp32: erf may differ by an ulp between the two
    # libraries, which can move a value across an integer
    assert np.abs(got - want).max() <= 1 and (got != want).mean() < 0.05


@pytest.mark.parametrize("steps", [50, 6])
def test_flagship_schedule_and_step_k_equal(steps):
    js, ts = j_flow.make_schedule(steps), t_flow.make_schedule(steps)
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k])
    jd = j_diti.make_diti(512, "200,400,600,800,1000", "192,184,72,48,16")
    td = t_diti.make_diti(512, "200,400,600,800,1000", "192,184,72,48,16")
    np.testing.assert_array_equal(t_flow.precompute_step_k(td, ts),
                                  j_flow.precompute_step_k(jd, js))


# ---------------------------------------------------------------- config --

def test_flagship_config_objects_equal_jax():
    """The port's flagship yml, through the port's
    tokenizer_config_from_params, yields the same EncoderConfig / MMDiTConfig
    values as the JAX package's tokenizer_config_from_params."""
    import dataclasses

    params = dict(load_config(FLAGSHIP_CONFIG).tokenizer.params)
    jparams = dict(j_load_config(FLAGSHIP_CONFIG).tokenizer.params)
    got, want = tokenizer_config_from_params(params), j_tokenizer_config(jparams)
    assert dataclasses.asdict(got.encoder) == dataclasses.asdict(want.encoder)
    assert dataclasses.asdict(got.decoder) == dataclasses.asdict(want.decoder)
    for f in ("k", "t2k", "stages", "k_per_stage", "k_m", "k_s", "image_size",
              "context_see_xt", "diffusion", "quantizer", "enc_name", "model_name"):
        assert getattr(got, f) == getattr(want, f), f
    e, d = got.encoder, got.decoder
    assert (e.hidden_size, e.num_heads, e.query_dim, e.query_heads, e.depth, e.K,
            e.patch_size, e.codebook_size, e.code_dim) == (64, 4, 512, 8, 16, 512, 2, 32768, 16)
    assert (d.depth, d.hidden_size, d.num_heads, d.time_adaln, d.K) == (24, 1536, 24, "pos_emb", 512)


def test_out_of_slice_modes_raise_not_implemented():
    """Every named encoder of the zoo builds now, the multi-resolution one
    too (its weights are ``QformerEncoderMultiRes``); what still raises
    NotImplementedError is the option no reference config combines: the
    multi-resolution MMDiT under 'pos_t_emb'. The bidirectional, zero-init
    and plain-ViT encoders, the renderer and pooled conditioning build
    (tests/test_torch_zoo_*.py and tests/test_torch_multires.py hold them
    against JAX)."""
    params = dict(load_config(TINY).tokenizer.params)
    for enc, mode in (("Enc-Qformer-Bi-L/2", "dual"), ("Enc-Qformer-Uni0-WL/1", "dual"),
                      ("Enc-Tiny/8", "vit")):
        cfg = tokenizer_config_from_params(dict(params, enc=enc))
        assert ImageTokenizer(cfg, encode_only=True).encoder.cfg.qformer_mode == mode
    cfg = tokenizer_config_from_params(dict(params, model="MMDiT_XL_Renderer"))
    assert ImageTokenizer(cfg).model.mask_token.shape[-1] == cfg.decoder.hidden_size
    cfg = tokenizer_config_from_params(dict(params, decoder_config=dict(
        params["decoder_config"], sd3_cond_pooling="last")))
    assert ImageTokenizer(cfg).model.y_embedder is not None
    cfg = tokenizer_config_from_params(dict(params, enc="Enc-Qformer-Multi-Res-Uni-XL/2"))
    want = j_tokenizer_config(dict(j_load_config(TINY).tokenizer.params,
                                   enc="Enc-Qformer-Multi-Res-Uni-XL/2")).encoder
    assert dataclasses.asdict(cfg.encoder) == dataclasses.asdict(want)
    assert len(t_enc.QformerEncoderMultiRes(cfg.encoder).blocks) == cfg.encoder.depth
    dec = dataclasses.replace(cfg.decoder, depth=2, time_adaln="pos_t_emb")
    with pytest.raises(NotImplementedError, match="pos_t_emb"):
        t_mm.mmdit_multires_apply(t_mm.MMDiT(dec, multires=True), dec, torch.zeros(1, 8, 8, 16),
                             torch.zeros(1), torch.zeros(1, dec.K, 16),
                             torch.zeros(1, dec.K, 16), torch.zeros(1, 4, 4, 16))


# --------------------------------------------------------------- encoder --

@pytest.fixture(scope="module")
def enc_pair():
    tcfg_j = j_tokenizer_config(dict(j_load_config(TINY).tokenizer.params))
    tcfg_t = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    tree = seeded_tree(lambda k: j_enc.encoder_init(k, tcfg_j.encoder), 11,
                       encoder_tables(tcfg_j.encoder))
    tok = convert.tokenizer_from_jax_tree({"encoder": tree}, tcfg_t)
    x = np.random.default_rng(5).standard_normal((32, 8, 8, 16)).astype(np.float32)
    return tcfg_j.encoder, jax_tree(tree), tcfg_t.encoder, tok.encoder, x


def test_vq_functions(enc_pair):
    jcfg, jp, tcfg, tp, _ = enc_pair
    feats = np.random.default_rng(6).standard_normal((2, 8, 64)).astype(np.float32)
    jids, jz = j_vq.vq_encode(jp["quantizer"], jnp.asarray(feats))
    with torch.no_grad():
        tids, tz = t_vq.vq_encode(tp.quantizer, torch.from_numpy(feats))
        mids, tmarg = t_vq.vq_margins(tp.quantizer, torch.from_numpy(feats))
    _, jmarg = j_vq.vq_margins(jp["quantizer"], jnp.asarray(feats))
    # fp32 matmul + l2norm on both sides: summation order only
    np.testing.assert_allclose(to_np(tz), to_np(jz), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(tmarg), to_np(jmarg), rtol=1e-4, atol=1e-5)
    safe = to_np(jmarg) > 1e-5
    assert tids.dtype == torch.int32
    np.testing.assert_array_equal(to_np(tids)[safe], to_np(jids)[safe])
    np.testing.assert_array_equal(to_np(mids)[safe], to_np(jids)[safe])
    ids = np.random.default_rng(7).integers(0, 64, (2, 8))
    with torch.no_grad():
        got = t_vq.get_output_from_indices(tp.quantizer, torch.from_numpy(ids))
    want = j_vq.get_output_from_indices(jp["quantizer"], jnp.asarray(ids))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-6)


def test_encoder_apply_fp32_features_and_ids(enc_pair):
    jcfg, jp, tcfg, tp, x = enc_pair
    j_outs = j_enc.get_encoder_outs(jp, jcfg, j_enc._embed_patches(jp, jcfg, jnp.asarray(x)))
    j_q, j_ids = j_enc.encoder_apply(jp, jcfg, jnp.asarray(x))
    _, j_marg = j_enc.encoder_margins(jp, jcfg, jnp.asarray(x))
    with torch.no_grad():
        xt = torch.from_numpy(x)
        t_outs = t_enc.get_encoder_outs(tp, tcfg, t_enc._embed_patches(tp, tcfg, xt))
        t_q, t_ids = t_enc.encoder_apply(tp, tcfg, xt)
    # pre-VQ features: fp32 on both sides through 2 blocks, 1e-4
    np.testing.assert_allclose(to_np(t_outs), to_np(j_outs), rtol=1e-4, atol=1e-4)
    # ids exactly equal wherever the JAX top-2 margin exceeds 1e-5 (below it
    # an fp32 rounding difference may legitimately flip the argmax)
    safe = to_np(j_marg) > 1e-5
    n_exempt = int((~safe).sum())
    print(f"tokens exempt from id equality (margin <= 1e-5): {n_exempt}/{safe.size}")
    assert n_exempt < 0.005 * safe.size
    np.testing.assert_array_equal(to_np(t_ids)[safe], to_np(j_ids)[safe])
    same = to_np(t_ids) == to_np(j_ids)
    np.testing.assert_allclose(to_np(t_q)[same], to_np(j_q)[same], rtol=1e-4, atol=1e-4)


def test_encoder_seven_tuple_and_mask(enc_pair):
    jcfg, jp, tcfg, tp, x = enc_pair
    d, x = np.array([0, 3, 7]), x[:3]
    jout = j_enc.encoder_apply(jp, jcfg, jnp.asarray(x), d=jnp.asarray(d))
    with torch.no_grad():
        tout = t_enc.encoder_apply(tp, tcfg, torch.from_numpy(x), d=torch.from_numpy(d))
    assert len(tout) == 7
    np.testing.assert_array_equal(to_np(tout[3]), to_np(jout[3]))
    same = (to_np(tout[6]) == to_np(jout[6]))
    np.testing.assert_allclose(to_np(tout[0])[same], to_np(jout[0])[same], rtol=1e-4, atol=1e-4)


def test_encoder_bf16_trunk_features(enc_pair):
    jcfg, jp, tcfg, tp, x = enc_pair
    je = j_enc._embed_patches(jp, jcfg, jnp.asarray(x))
    j_outs = j_enc.get_encoder_outs(jp, jcfg, je, trunk_dtype=jnp.bfloat16, fast_attn=True)
    with torch.no_grad():
        xt = torch.from_numpy(x)
        t_outs = t_enc.get_encoder_outs(tp, tcfg, t_enc._embed_patches(tp, tcfg, xt),
                                        trunk_dtype=torch.bfloat16, fast_attn=True)
    assert t_outs.dtype == torch.bfloat16
    # bf16 activations round at different places in the two frameworks, and
    # the JAX side keeps bf16 scores where the port's kernel arithmetic keeps
    # fp32 ones: 5e-2 on features of unit scale
    np.testing.assert_allclose(to_np(t_outs), to_np(j_outs), rtol=5e-2, atol=5e-2)
