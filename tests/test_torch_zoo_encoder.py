"""The encoder modes of the PyTorch port beyond the unidirectional dual one
(bidirectional, zero-init, ``attn_mask``, ``vit``, ``concat``, ``qformer``)
against the JAX package's ``encoder_apply``, fp32 on the CPU at a small
size with carried seeded weights; every named encoder of the zoo built by
both packages; and a ``vit`` tokenizer's ``tokenizer_loss`` gradients
against ``jax.grad``."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.models import zoo as j_zoo
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models import encoder as t_enc
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.models import zoo as t_zoo
from selftoktokenizer_tpu_torch.models import vq as t_vq
from tests.test_torch_train import B as TRAIN_B
from tests.test_torch_train import _assert_grads, _jax_loss_and_grads, _vq_draws
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

# fp32 on both sides through a few blocks: summation order only
REL_TOL = 1e-5
ID_MARGIN = 1e-6

BASE = dict(K=4, input_size=8, encoder_hidden_size=16, patch_size=2, in_channels=4,
            hidden_size=32, depth=2, num_heads=2, query_dim=32, query_heads=2,
            time_adaln=True, code_dim=8, codebook_size=64)
MODES = {
    "bidirectional": dict(bidirectional=True, qk_norm=True),
    "zero_init": dict(zero_init=True, query_dim=48, query_heads=3),
    "zero_init_attn_mask": dict(zero_init=True, attn_mask=True),
    "attn_mask": dict(attn_mask=True, query_dim=48, query_heads=3),
    "concat": dict(qformer_mode="concat"),
    "qformer": dict(qformer_mode="qformer", hidden_size=16, query_dim=32),
    # K = 2 groups of the last 2 of 3 blocks, 4 patches a token
    "vit": dict(qformer_mode="vit", K=2, depth=3, patch_size=4),
}


def _cfgs(mode):
    kw = {**BASE, **MODES[mode]}
    return j_enc.EncoderConfig(**kw), t_enc.EncoderConfig(**kw)


def _pair(mode, seed):
    jcfg, tcfg = _cfgs(mode)
    tree = seeded_tree(lambda k: j_enc.encoder_init(k, jcfg), seed, encoder_tables(jcfg))
    if "gate" in tree.get("blocks", {}):
        # a wide gate, so the image part's tanh(gate) is far from 0
        tree["blocks"]["gate"] = 30.0 * tree["blocks"]["gate"]
    enc = t_enc.QformerEncoder(tcfg)
    enc.load_state_dict(convert.encoder_state_dict(tree, tcfg), strict=True)
    return jcfg, jax_tree(tree), tcfg, enc.requires_grad_(False)


def _rel(got, want):
    return np.abs(to_np(got) - to_np(want)).max() / np.abs(to_np(want)).max()


@pytest.mark.parametrize("mode", list(MODES))
def test_encoder_mode_matches_jax(mode):
    jcfg, jp, tcfg, enc = _pair(mode, seed=sorted(MODES).index(mode) + 40)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    d = np.array([1, 3 if tcfg.K > 2 else 0], np.int32)
    want = j_enc.encoder_apply(jp, jcfg, jnp.asarray(x), d=jnp.asarray(d))
    got = t_enc.encoder_apply(enc, tcfg, torch.from_numpy(x), d=torch.from_numpy(d))
    w_ehs, w_outs, _, w_mask, _, _, w_ids = want
    g_ehs, g_outs, _, g_mask, _, _, g_ids = got
    ppt = 4 if mode == "vit" else 1
    assert tuple(g_outs.shape) == (2, tcfg.K * ppt, tcfg.encoder_out_dim)
    assert tuple(g_ids.shape) == (2, tcfg.K * ppt)
    np.testing.assert_array_equal(to_np(g_mask), to_np(w_mask))
    assert _rel(g_outs, w_outs) <= REL_TOL, _rel(g_outs, w_outs)
    _, margins = j_vq.vq_margins(jp["quantizer"], w_outs)
    diff = to_np(g_ids) != to_np(w_ids)
    assert not (diff & (to_np(margins) >= ID_MARGIN)).any(), int(diff.sum())
    same = ~diff
    assert _rel(to_np(g_ehs)[same], to_np(w_ehs)[same]) <= REL_TOL


def test_zero_init_gate_and_mask_matter():
    """The gate scales the image part and the mask is causal: each changes
    the query tokens, so neither test above would pass with it ignored."""
    jcfg, jp, tcfg, enc = _pair("zero_init_attn_mask", seed=7)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, 4)).astype(np.float32))
    base = t_enc.get_encoder_outs(enc, tcfg, t_enc._embed_patches(enc, tcfg, x))
    for blk in enc.blocks:
        blk.attn.gate.zero_()
    closed = t_enc.get_encoder_outs(enc, tcfg, t_enc._embed_patches(enc, tcfg, x))
    unmasked = t_enc.get_encoder_outs(
        enc, dataclasses.replace(tcfg, attn_mask=False), t_enc._embed_patches(enc, tcfg, x))
    assert (base - closed).abs().max() > 1e-3
    assert (closed - unmasked).abs().max() > 1e-3
    # the first query sees only itself among the queries, under either form
    causal_first = closed[:, 0]
    assert (causal_first - unmasked[:, 0]).abs().max() > 1e-4


def test_attn_mask_with_bidirectional_raises():
    _, tcfg = _cfgs("bidirectional")
    tcfg = dataclasses.replace(tcfg, attn_mask=True)
    enc = t_enc.QformerEncoder(tcfg)
    with pytest.raises(ValueError, match="bidirectional"):
        t_enc.get_encoder_outs(enc, tcfg, torch.zeros(1, 16, 32))


def _named(name):
    """(qformer_mode, K) that a named encoder is built with here: a plain
    ViT at its largest K; a Qformer entry in a mode its widths allow."""
    spec = t_zoo.ENC_MODELS[name]
    if spec.get("mode") == "vit":
        return "vit", spec.get("max_K", 8)
    if spec["hidden_size"] == spec["query_dim"]:
        return "concat", 32
    return ("qformer" if sorted(t_zoo.ENC_MODELS).index(name) % 2 else "dual"), 32


@pytest.mark.parametrize("name", [n for n in t_zoo.ENC_MODELS if "Multi-Res" not in n])
def test_every_named_encoder_builds_as_in_jax(name):
    """Every named encoder but the multi-resolution one builds in the port,
    with the reference's leaves: the port's parameter count equals the
    JAX init's (traced for shapes only), at the entry's widths and two
    blocks."""
    mode, K = _named(name)
    ec = {"qformer_mode": mode, "time_adaln": True, "pos_embed_max_size": 8}
    qc = {"code_dim": 16, "codebook_size": 32768}
    args = (name, K, 32, 16, 16, qc)
    tcfg = t_zoo.build_encoder_config(*args, encoder_config=dict(ec))
    jcfg = j_zoo.build_encoder_config(*args, encoder_config=dict(ec))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    cut = dict(depth=2, K=2) if mode == "vit" else dict(depth=2)
    tcfg, jcfg = dataclasses.replace(tcfg, **cut), dataclasses.replace(jcfg, **cut)
    with torch.device("meta"):
        enc = t_enc.QformerEncoder(tcfg)
    shapes = jax.eval_shape(lambda k: j_enc.encoder_init(k, jcfg), jax.random.PRNGKey(0))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in enc.parameters()) == want


def test_multires_encoder_still_raises():
    """The multi-resolution entry no longer raises: both packages build the
    same config from it, and the port's multi-resolution encoder takes it
    (tests/test_torch_multires.py holds that encoder against JAX)."""
    args = ("Enc-Qformer-Multi-Res-Uni-XL/2", 32, 32, 16, 16,
            {"code_dim": 16, "codebook_size": 64})
    cfg = t_zoo.build_encoder_config(*args)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_zoo.build_encoder_config(*args))
    enc = t_enc.QformerEncoderMultiRes(cfg)
    assert len(enc.blocks) == cfg.depth == 16


# ------------------------------------------------------------ vit training --

def _vit_tokenizer_cfgs():
    """The tiny tokenizer with the plain-ViT encoder Enc-Tiny/8 narrowed to
    width 32: at 64 px each image is one patch, so each token one patch (a
    decoder context of K tokens)."""
    raw = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    raw["enc"] = "Enc-Tiny/8"
    jtc = j_tok.tokenizer_config_from_params(raw)
    ttc = t_tok.tokenizer_config_from_params(dict(raw))
    narrow = dict(hidden_size=32, num_heads=4)
    jtc = dataclasses.replace(jtc, encoder=dataclasses.replace(jtc.encoder, **narrow))
    ttc = dataclasses.replace(ttc, encoder=dataclasses.replace(ttc.encoder, **narrow))
    return jtc, ttc


def test_vit_tokenizer_loss_gradients_match_jax():
    """The vit tokenizer's loss, VQ ids and every gradient leaf against
    jax.grad through the training quantizer (straight-through), with the
    draws handed to both sides, by the rule of tests/test_torch_train.py."""
    jtc, ttc = _vit_tokenizer_cfgs()
    assert ttc.encoder.qformer_mode == "vit" and ttc.encoder.depth == ttc.k
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 61, tables)
    rng = np.random.default_rng(62)
    x = rng.standard_normal((TRAIN_B, 8, 8, 16)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    t = np.array([0.2, 0.5, 0.8, 0.95], np.float32)
    drop = np.array([False, True, False, False])
    key = jax.random.PRNGKey(63)
    j_loss, j_aux, j_grads = _jax_loss_and_grads(jtc, tree, x, key, t=t, noise=noise,
                                                 drop_ids=drop)
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    T = torch.from_numpy
    loss, aux = t_tok.tokenizer_loss(
        tok, ttc, T(x), vq_state=t_vq.vq_state_init(tok.encoder.quantizer, ttc.k), t=T(t),
        noise=T(noise), drop_ids=T(drop), **_vq_draws(key, ttc))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    np.testing.assert_array_equal(to_np(aux["ids"]), to_np(j_aux["ids"]))
    _assert_grads(tok, convert.tokenizer_state_dict(j_grads, ttc))
    # the loss reaches the ViT trunk's first block
    assert float(tok.encoder.blocks[0].mlp.fc1.weight.grad.abs().max()) > 0
