"""The multi-resolution models of the PyTorch port against the JAX package,
fp32 on the CPU at a small size with carried seeded weights (non-zero
everywhere): the multi-resolution encoder against ``multires_encoder_apply``
(ids equal outside a 1e-6 top-2 margin, the rest within 1e-4 of scale), the
multi-resolution MMDiT against ``mmdit_multires_apply`` (masks that leave
no row without an active key, within 1e-4 of scale), ``multi_tokenizer_loss``
and its gradients against ``jax.value_and_grad`` with JAX's own draws (loss
within 1e-5 relative, each gradient leaf within 1e-4 of its scale), the
zoo's multi-resolution entry, and the round trip of the port's state dict
through the JAX package's ``*_from_state_dict``."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import mmdit as j_mm
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.models import zoo as j_zoo
from selftoktokenizer_tpu.ops.posembed import sincos_1d
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import encoder as t_enc
from selftoktokenizer_tpu_torch.models import mmdit as t_mm
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.models import zoo as t_zoo
from tests.torch_port_helpers import (
    encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

REL_TOL = 1e-4
ID_MARGIN = 1e-6
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4

# the JAX package's multi-resolution encoder test's geometry
ENC = dict(K=8, input_size=8, encoder_hidden_size=8, patch_size=2, in_channels=16,
           hidden_size=32, depth=2, num_heads=4, pre_norm=False, post_norm=True,
           qformer_mode="dual", pos_embed_max_size=16, query_dim=64, query_heads=8,
           time_adaln=True, code_dim=8, codebook_size=128, low_res_hidden_size=64,
           low_res_code_dim=8, low_res_codebook_size=128, low_res_K=6, low_res_heads=8)
MM = dict(depth=2, K=6, patch_size=2, in_channels=16, pos_embed_max_size=8, num_patches=64,
          encoder_hidden_size=8, context_dim=128, adm_in_channels=8, time_adaln="pos_emb")


def _rel(got, want):
    got, want = to_np(got), to_np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _enc_tables(cfg):
    return {**encoder_tables(cfg), ("low_res_hidden_pos_embed",): sincos_1d(
        cfg.low_res_hidden_size, np.arange(cfg.low_res_K, dtype=np.float32))[None]}


def _enc_pair(seed, **kw):
    jcfg, tcfg = j_enc.EncoderConfig(**{**ENC, **kw}), t_enc.EncoderConfig(**{**ENC, **kw})
    tree = seeded_tree(lambda k: j_enc.multires_encoder_init(k, jcfg), seed, _enc_tables(jcfg))
    return jcfg, tree, tcfg, convert.multires_encoder_from_jax_tree(tree, tcfg)


def _enc_inputs(cfg):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    te = rng.standard_normal((2, cfg.low_res_K, cfg.low_res_code_dim)).astype(np.float32)
    return x, te, np.array([3, 7], np.int32)


def _check_encode(want, got, jp):
    w_ehs, w_outs, _, w_mask, _, _, w_ids = want
    g_ehs, g_outs, _, g_mask, _, _, g_ids = got
    np.testing.assert_array_equal(to_np(g_mask), to_np(w_mask))
    assert _rel(g_outs, w_outs) <= REL_TOL, _rel(g_outs, w_outs)
    _, margins = j_vq.vq_margins(jp["quantizer"], w_outs)
    diff = to_np(g_ids) != to_np(w_ids)
    assert not (diff & (to_np(margins) >= ID_MARGIN)).any(), int(diff.sum())
    assert _rel(to_np(g_ehs)[~diff], to_np(w_ehs)[~diff]) <= REL_TOL


@pytest.mark.parametrize("kw", [{}, {"low_res_code_dim": 64, "time_adaln": False}],
                         ids=["token_embedder", "no_token_embedder_no_adaln"])
def test_multires_encoder_matches_jax(kw):
    jcfg, tree, tcfg, enc = _enc_pair(31, **kw)
    assert hasattr(enc, "token_embedder") == (tcfg.low_res_code_dim != tcfg.low_res_hidden_size)
    x, te, d = _enc_inputs(tcfg)
    jp = jax_tree(tree)
    want = j_enc.multires_encoder_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(te),
                                        d=jnp.asarray(d))
    with torch.no_grad():
        got = t_enc.multires_encoder_apply(enc, tcfg, torch.from_numpy(x), torch.from_numpy(te),
                                           d=torch.from_numpy(d))
    assert tuple(got[-1].shape) == (2, tcfg.K)
    _check_encode(want, got, jp)


def test_multires_encoder_adaln_positions_are_arange():
    """The adaLN positions are K_low..K_low+K-1 (query) and 0..K_low-1
    (low-res), not the diti table 1000 + 8k."""
    _, _, tcfg, enc = _enc_pair(32)
    blk = enc.blocks[0]
    mods, low = t_enc.dual_block_multires_mods(blk, tcfg.K, tcfg.low_res_K, "cpu")
    t_emb = t_enc.timestep_embedder_apply(
        blk.t_embedder, torch.arange(tcfg.low_res_K, tcfg.low_res_K + tcfg.K))
    lin = blk.adaLN_modulation[1]
    want = torch.nn.functional.linear(torch.nn.functional.silu(t_emb), lin.weight, lin.bias)
    assert torch.allclose(torch.cat(mods, dim=1), want)
    assert tuple(low[0].shape) == (tcfg.low_res_K, tcfg.low_res_hidden_size)


def test_multires_encoder_state_dict_round_trip():
    """The port's state dict through the JAX package's converter gives the
    port's output: the port's names are the reference's."""
    jcfg, _, tcfg, enc = _enc_pair(33)
    sd = {k: v.numpy() for k, v in enc.state_dict().items()}
    jp = jax_tree(j_enc.multires_encoder_from_state_dict(sd, jcfg))
    x, te, d = _enc_inputs(tcfg)
    want = j_enc.multires_encoder_apply(jp, jcfg, jnp.asarray(x), jnp.asarray(te),
                                        d=jnp.asarray(d))
    with torch.no_grad():
        got = t_enc.multires_encoder_apply(enc, tcfg, torch.from_numpy(x), torch.from_numpy(te),
                                           d=torch.from_numpy(d))
    _check_encode(want, got, jp)


def test_zoo_builds_the_multires_encoder():
    kw = dict(K=16, input_size=32, encoder_hidden_size=16, in_channels=16,
              quantizer_config={"code_dim": 16, "codebook_size": 64},
              encoder_config={"time_adaln": True, "pos_embed_max_size": 64})
    name = "Enc-Qformer-Multi-Res-Uni-XL/2"
    tcfg = t_zoo.build_encoder_config(name, **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(j_zoo.build_encoder_config(name, **kw))
    assert (tcfg.depth, tcfg.query_dim, tcfg.hidden_size, tcfg.low_res_K) == (16, 512, 64, 512)
    enc = t_enc.QformerEncoderMultiRes(tcfg)
    assert len(enc.blocks) == 16 and hasattr(enc, "token_embedder")
    x = torch.randn(1, 32, 32, 16)
    te = torch.randn(1, tcfg.low_res_K, tcfg.low_res_code_dim)
    with torch.no_grad():
        torch.nn.init.normal_(enc.query_tokens, std=0.02)
        outs_q, ids = t_enc.multires_encoder_apply(enc, tcfg, x, te)
    assert tuple(ids.shape) == (1, 16) and torch.isfinite(outs_q).all()


# ---------------------------------------------------------------- MMDiT ---

def _mm_pair(seed):
    jcfg, tcfg = j_mm.MMDiTConfig(**MM), t_mm.MMDiTConfig(**MM)
    tree = seeded_tree(lambda k: j_mm.mmdit_multires_init(k, jcfg), seed, mmdit_tables(jcfg))
    return jcfg, tree, tcfg, convert.mmdit_from_jax_tree(tree, tcfg)


def _mm_inputs():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    low = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)    # 4 rec tokens
    ehs = rng.standard_normal((2, 6, 8)).astype(np.float32)
    ehs_low = rng.standard_normal((2, 5, 8)).astype(np.float32)    # Kl = 5 < K
    t = np.array([0.6, 0.3], np.float32)
    # every row keeps an active token key: no row is left without a key
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], bool)
    cl_mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 0]], bool)
    return x, low, ehs, ehs_low, t, mask, cl_mask


def _mm_run(jcfg, jp, tcfg, model, see_xt, see_rec):
    x, low, ehs, ehs_low, t, mask, cl_mask = _mm_inputs()
    want = j_mm.mmdit_multires_apply(
        jp, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ehs), jnp.asarray(ehs_low),
        jnp.asarray(low), mask=jnp.asarray(mask), context_lowres_mask=jnp.asarray(cl_mask),
        context_see_xt=see_xt, context_see_rec=see_rec)
    with torch.no_grad():
        got = t_mm.mmdit_multires_apply(
            model, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs),
            torch.from_numpy(ehs_low), torch.from_numpy(low), mask=torch.from_numpy(mask),
            context_lowres_mask=torch.from_numpy(cl_mask), context_see_xt=see_xt,
            context_see_rec=see_rec)
    assert got.shape == (2, 8, 8, 16)
    return want, got


@pytest.mark.parametrize("see_xt,see_rec", [(True, True), (False, False), (True, False)])
def test_mmdit_multires_matches_jax(see_xt, see_rec):
    jcfg, tree, tcfg, model = _mm_pair(41)
    want, got = _mm_run(jcfg, jax_tree(tree), tcfg, model, see_xt, see_rec)
    assert np.isfinite(to_np(want)).all()
    assert _rel(got, want) <= REL_TOL, _rel(got, want)


def test_mmdit_multires_state_dict_round_trip():
    jcfg, _, tcfg, model = _mm_pair(42)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert any(".context_block_low_res." in k for k in sd) and any(".rec_block." in k for k in sd)
    jp = jax_tree(j_mm.mmdit_from_state_dict(sd, jcfg))
    want, got = _mm_run(jcfg, jp, tcfg, model, True, True)
    assert _rel(got, want) <= REL_TOL, _rel(got, want)
    # the reference's names load strictly into a fresh module
    again = t_mm.mmdit_from_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert set(again.state_dict()) == set(sd)


def test_mmdit_multires_fully_masked_row_is_the_uniform_mean():
    """A row with no active key: the port's finite -1e30 bias gives the
    mean of every value (the reference's -inf gives NaN)."""
    _, _, tcfg, model = _mm_pair(43)
    x, low, ehs, ehs_low, t, mask, cl_mask = _mm_inputs()
    mask[0] = False
    cl_mask[0] = False
    with torch.no_grad():
        out = t_mm.mmdit_multires_apply(
            model, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ehs),
            torch.from_numpy(ehs_low), torch.from_numpy(low), mask=torch.from_numpy(mask),
            context_lowres_mask=torch.from_numpy(cl_mask))
    assert torch.isfinite(out).all()


def test_mmdit_multires_refuses_pos_t_emb():
    cfg = t_mm.MMDiTConfig(**{**MM, "time_adaln": "pos_t_emb"})
    model = t_mm.MMDiT(cfg, multires=True)
    with pytest.raises(NotImplementedError, match="pos_t_emb"):
        t_mm.mmdit_multires_apply(model, cfg, torch.zeros(1, 8, 8, 16), torch.zeros(1),
                                  torch.zeros(1, 6, 8), torch.zeros(1, 6, 8),
                                  torch.zeros(1, 4, 4, 16))


# ------------------------------------------------------------ tokenizer ---

B, K = 2, 4


def _multi_cfgs():
    enc = dict(K=K, input_size=8, encoder_hidden_size=8, patch_size=2, in_channels=16,
               hidden_size=32, depth=2, num_heads=4, query_dim=64, query_heads=8,
               pos_embed_max_size=16, time_adaln=True, code_dim=8, codebook_size=64)
    dec = dict(depth=2, K=2 * K, pos_embed_max_size=16, num_patches=256, encoder_hidden_size=8,
               context_dim=128, adm_in_channels=8, time_adaln="pos_emb", in_channels=16)
    common = dict(k=K, stages="500,1000", k_per_stage="2,2", image_size=64,
                  train_encoder_res="res256", diffusion={"parameterization": "velocity"},
                  quantizer={"dead_code_threshold": 0.5, "w_diversity": 1.0, "w_commit": 1.0})
    out = []
    for E, M, C in ((j_enc.EncoderConfig, j_mm.MMDiTConfig, j_tok.MultiTokenizerConfig),
                    (t_enc.EncoderConfig, t_mm.MMDiTConfig, t_tok.MultiTokenizerConfig)):
        out.append(C(encoders={"res256": E(**enc), "res512": E(**enc)}, decoder=M(**dec),
                     **common))
    return out


def _multi_tree(jcfg, seed):
    tables = {**mmdit_tables(jcfg.decoder, ("model",))}
    for res, ec in jcfg.encoders.items():
        tables.update(encoder_tables(ec, ("encoder", res)))
    return seeded_tree(lambda k: j_tok.multi_tokenizer_init(k, jcfg), seed, tables)


def _draws(key, jcfg, x_shape):
    """The loss's draws as the JAX package makes them: (r_t, r_noise) =
    split(key); each resolution i's quantizer from fold_in(key, 100 + i),
    split into (reactivation, k-means)."""
    r_t, r_noise = jax.random.split(key)
    t = np.asarray(jax.random.uniform(r_t, (x_shape[0],)))
    noise = np.asarray(jax.random.normal(r_noise, x_shape, jnp.float32))
    vq = {}
    for i, (res, ec) in enumerate(jcfg.encoders.items()):
        r, r_km = jax.random.split(jax.random.fold_in(key, 100 + i))
        C = ec.codebook_size
        assert B * K < C
        vq[res] = {"kmeans_idx": torch.from_numpy(np.array(jax.random.randint(
                       r_km, (C,), 0, B * K))),
                   "react_uniforms": torch.from_numpy(np.array(jax.random.uniform(r, (C,))))}
    return torch.from_numpy(t.copy()), torch.from_numpy(noise.copy()), vq


@pytest.mark.parametrize("full_tokens", [False, True])
def test_multi_tokenizer_loss_and_grads_match_jax(full_tokens):
    jcfg, tcfg = _multi_cfgs()
    tree = _multi_tree(jcfg, 51)
    rng = np.random.default_rng(6)
    batch = {r: rng.standard_normal((B, 8, 8, 16)).astype(np.float32) for r in jcfg.encoders}
    key = jax.random.PRNGKey(9)
    jp = jax_tree(tree)
    states = {r: j_vq.vq_state_init(jp["encoder"][r]["quantizer"], K) for r in jcfg.encoders}

    def f(p):
        return j_tok.multi_tokenizer_loss(p, jcfg, {r: jnp.asarray(v) for r, v in batch.items()},
                                          key, vq_states=states, full_tokens=full_tokens)

    # the loss eager: it is the flow MSE plus a VQ loss of nearly the same
    # size and opposite sign, and the fused reductions of a jitted call move
    # the sum by 2e-5 of itself (the port equals the eager value bit for
    # bit); the gradients jitted, once (the two cases share the graph but
    # for the token mask)
    w_loss, w_aux = f(jp)

    tok = convert.multi_tokenizer_from_jax_tree(tree, tcfg)
    t, noise, vq_draws = _draws(key, jcfg, batch["res256"].shape)
    t_states = {r: convert.vq_state_from_jax(s) for r, s in states.items()}
    loss, aux = t_tok.multi_tokenizer_loss(
        tok, tcfg, {r: torch.from_numpy(v) for r, v in batch.items()}, vq_states=t_states,
        full_tokens=full_tokens, t=t, noise=noise, vq_draws=vq_draws)
    loss.backward()
    assert abs(float(loss.detach()) - float(w_loss)) <= LOSS_RTOL * abs(float(w_loss))
    assert abs(float(aux["log_dict"]["mse"]) - float(w_aux["log_dict"]["mse"])) \
        <= LOSS_RTOL * abs(float(w_aux["log_dict"]["mse"]))
    for r in jcfg.encoders:
        ws, gs = w_aux["vq_states"][r], aux["vq_states"][r]
        assert _rel(gs.embed, ws.embed) <= 1e-5
        assert int(gs.steps) == int(np.asarray(ws.steps))
    if full_tokens:
        return
    w_grads = jax.jit(jax.grad(lambda p: f(p)[0]))(jp)
    w_grads = convert.multi_tokenizer_state_dict(jax.tree_util.tree_map(np.asarray, w_grads),
                                                 tcfg)
    seen = 0
    for n, p in tok.named_parameters():
        if n.endswith("quantizer._codebook.embed"):     # moved by EMA, not by gradients
            continue
        want = w_grads[n].numpy()
        got = np.zeros_like(want) if p.grad is None else to_np(p.grad)
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= GRAD_TOL * scale or err <= 1e-10, (n, err, scale)
        seen += 1
    assert seen == len(w_grads) - 2


def test_multi_tokenizer_interleaves_token_major():
    """Context row 2k + r is resolution r's token k (stack on dim 2, then
    flatten): swapping the two encoders' weights swaps the even and odd
    context rows the decoder sees."""
    _, tcfg = _multi_cfgs()
    tok = t_tok.MultiImageTokenizer(tcfg)
    gen = torch.Generator().manual_seed(0)
    for p in tok.parameters():
        with torch.no_grad():
            p.normal_(std=0.1, generator=gen)
    seen = []
    orig = t_tok.mmdit_apply

    def spy(model, cfg, x_t, tt, ehs, **kw):
        seen.append(ehs.detach().clone())
        return orig(model, cfg, x_t, tt, ehs, **kw)

    x = torch.randn((B, 8, 8, 16), generator=gen)
    batch = {"res256": x, "res512": torch.randn((B, 8, 8, 16), generator=gen)}
    t = torch.tensor([0.9, 0.99])
    try:
        t_tok.mmdit_apply = spy
        t_tok.multi_tokenizer_loss(tok, tcfg, batch, t=t, noise=torch.zeros_like(x),
                                   full_tokens=True)
        outs = [t_enc.encoder_apply(tok.encoder[r], tcfg.encoders[r], batch[r])[0]
                for r in ("res256", "res512")]
    finally:
        t_tok.mmdit_apply = orig
    ehs = seen[0]
    assert ehs.shape == (B, 2 * K, 8)
    assert torch.allclose(ehs[:, 0::2], outs[0]) and torch.allclose(ehs[:, 1::2], outs[1])
