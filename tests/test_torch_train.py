"""The training path on the CPU: the port's tokenizer loss, flow loss,
train step and resume against the JAX package's, on the same carried
seeded weights (non-zero everywhere), the same numpy latents and the same
random draws (the reference's own: the test splits its keys as it does).
The optimizer is held in tests/test_torch_train_optimizer.py, the
renderer's step in tests/test_torch_renderer_loss.py.

Tolerances: loss, log dict and VQ state within 1e-5 relative; ids equal;
each gradient leaf within 1e-4 of its own largest magnitude (the sinusoidal
timestep embeddings' first layers are the least exact: 3e-5 measured)."""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import flow as j_flow
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import flow as t_flow
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.models import vq as t_vq
from selftoktokenizer_tpu_torch.train import trainer as t_trainer
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_tree, mmdit_tables, seeded_tree, to_np)

B = 4
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = 1e-4


def _close(got, want, rel=1e-5, what=""):
    """max |got - want| within rel of max |want|."""
    got, want = to_np(got), to_np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale or err <= 1e-12, (what, err, scale)
FROZEN = "encoder.quantizer._codebook.embed"    # moved by EMA, not by gradients


def _configs():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    return t_tok.tokenizer_config_from_params(params), j_tok.tokenizer_config_from_params(params)


def _tree(jtc, seed):
    return seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), seed,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})


@pytest.fixture(scope="module")
def tiny():
    ttc, jtc = _configs()
    tree = _tree(jtc, 5)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 8, 8, 16)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    # one t in each of the loss's strata
    t = np.array([0.2, 0.5, 0.8, 0.95], np.float32)
    return ttc, jtc, tree, x, noise, t


def _vq_draws(key, ttc):
    """The quantizer's draws as the reference makes them inside
    tokenizer_loss: (r_t, r_noise, r_drop, r_react) = split(key, 4), then
    (rng, r_km) = split(r_react); k-means from r_km (randint: B*K < C),
    reactivation's choice from rng."""
    r_react = jax.random.split(key, 4)[3]
    rng, r_km = jax.random.split(r_react)
    C = ttc.encoder.codebook_size
    assert B * ttc.k < C
    km = jax.random.randint(r_km, (C,), 0, B * ttc.k)
    return {"kmeans_idx": torch.from_numpy(np.array(km)),
            "react_uniforms": torch.from_numpy(np.array(jax.random.uniform(rng, (C,))))}


def _jax_loss_and_grads(jtc, tree, x, key, **kw):
    jp = jax_tree(tree)
    st = j_vq.vq_state_init(jp["encoder"]["quantizer"], jtc.k)
    kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}

    def f(p):
        return j_tok.tokenizer_loss(p, jtc, jnp.asarray(x), key, vq_state=st, **kw)

    (loss, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jp)
    return loss, aux, jax.tree_util.tree_map(np.asarray, grads)


def _assert_grads(module, j_grads_sd, skip=(FROZEN,)):
    seen = 0
    for n, p in module.named_parameters():
        if n in skip:
            continue
        want = j_grads_sd[n].numpy()
        # a leaf the loss does not reach: no grad here, zeros there
        got = np.zeros_like(want) if p.grad is None else to_np(p.grad)
        err, scale = np.abs(got - want).max(), np.abs(want).max()
        assert err <= GRAD_TOL * scale or err <= 1e-10, (n, err, scale)
        seen += 1
    assert seen == len(j_grads_sd) - len(skip)


@pytest.mark.parametrize("see_xt", [True, False])
def test_tokenizer_loss_and_grads_match_jax(tiny, see_xt):
    ttc, jtc, tree, x, noise, t = tiny
    ttc = dataclasses.replace(ttc, context_see_xt=see_xt)
    jtc = dataclasses.replace(jtc, context_see_xt=see_xt)
    # with context_see_xt=False a dropped sample's context rows have no
    # active key, which the reference's full mask turns into NaN: drop none
    drop = np.array([False, True, False, False]) if see_xt else np.zeros(B, bool)
    key = jax.random.PRNGKey(3)
    j_loss, j_aux, j_grads = _jax_loss_and_grads(jtc, tree, x, key, t=t, noise=noise,
                                                 drop_ids=drop)
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    T = torch.from_numpy
    loss, aux = t_tok.tokenizer_loss(
        tok, ttc, T(x), vq_state=t_vq.vq_state_init(tok.encoder.quantizer, ttc.k), t=T(t),
        noise=T(noise), drop_ids=T(drop), **_vq_draws(key, ttc))
    loss.backward()

    _close(loss.detach(), j_loss, what="loss")
    assert set(aux["log_dict"]) == set(j_aux["log_dict"])
    for k, v in aux["log_dict"].items():
        _close(v, j_aux["log_dict"][k], what=k)
    assert float(aux["log_dict"]["loss_uncon"]) > 0 or not see_xt
    np.testing.assert_array_equal(to_np(aux["ids"]), to_np(j_aux["ids"]))
    for f in ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count"):
        _close(getattr(aux["vq_state"], f), getattr(j_aux["vq_state"], f), what=f)
    assert int(aux["log_dict"]["vq_n_reactive"]) > 0
    # the reference's codebook leaf gets a zero gradient: the EMA moves it
    assert np.abs(j_grads["encoder"]["quantizer"]["embed"]).max() == 0
    _assert_grads(tok, convert.tokenizer_state_dict(j_grads, ttc))


@pytest.mark.parametrize("kw", [
    dict(parameterization="velocity"), dict(parameterization="x0"),
    dict(parameterization="eps"), dict(force_recon=True), dict(force_recon=True, recon_ratio=0.7),
    dict(loss_mask=True), dict(drop_ids=True)], ids=lambda kw: "-".join(kw))
def test_flow_training_losses_match(kw):
    rng = np.random.default_rng(7)
    x, noise = (rng.standard_normal((4, 6, 6, 3)).astype(np.float32) for _ in range(2))
    w = rng.standard_normal((3, 3)).astype(np.float32)
    t = np.array([0.1, 0.4, 0.6, 0.9], np.float32)
    j_kw, t_kw = dict(kw), dict(kw)
    if kw.get("loss_mask"):
        m = rng.random((4, 6, 6)) > 0.3
        j_kw["loss_mask"], t_kw["loss_mask"] = jnp.asarray(m), torch.from_numpy(m)
    if kw.get("drop_ids"):
        d = np.array([True, False, True, False])
        j_kw["drop_ids"], t_kw["drop_ids"] = jnp.asarray(d), torch.from_numpy(d)
    want = j_flow.training_losses(
        lambda xt, tt: jnp.tanh(xt @ w) * tt[:, None, None, None], jnp.asarray(x), jnp.asarray(t),
        jnp.asarray(noise), **j_kw)
    got = t_flow.training_losses(
        lambda xt, tt: torch.tanh(xt @ torch.from_numpy(w)) * tt[:, None, None, None],
        torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(noise), **t_kw)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(to_np(got[k]), to_np(want[k]), err_msg=k, **TOL)


def _port_grads(ttc, tree, x, noise, t, draws):
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    T = torch.from_numpy
    loss, _ = t_tok.tokenizer_loss(
        tok, ttc, T(x), vq_state=t_vq.vq_state_init(tok.encoder.quantizer, ttc.k), t=T(t),
        noise=T(noise), drop_ids=torch.tensor([False, True, False, False]), **draws)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in tok.named_parameters() if p.requires_grad}


def test_checkpointing_gives_the_same_grads(tiny):
    ttc, _, tree, x, noise, t = tiny
    draws = _vq_draws(jax.random.PRNGKey(3), ttc)
    remat = dataclasses.replace(
        ttc, encoder=dataclasses.replace(ttc.encoder, gradient_checkpointing=True),
        decoder=dataclasses.replace(ttc.decoder, use_checkpoint=True))
    loss, grads = _port_grads(ttc, tree, x, noise, t, draws)
    loss_r, grads_r = _port_grads(remat, tree, x, noise, t, draws)
    assert loss == loss_r
    for n, g in grads.items():
        torch.testing.assert_close(grads_r[n], g, rtol=1e-6, atol=1e-9, msg=n)


def test_l2_anchor_pulls_toward_the_ema_encoder(tiny):
    # held against the formula (the reference's branch cannot run: its
    # tokenizer_loss names an _embed_patches it never imports there)
    ttc, _, tree, x, noise, t = tiny
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    ema = convert.tokenizer_from_jax_tree(
        {"encoder": jax.tree_util.tree_map(lambda a: a * np.float32(1.3), tree["encoder"])},
        ttc).encoder
    T = torch.from_numpy
    kw = dict(t=T(t), noise=T(noise), drop_ids=torch.zeros(B, dtype=torch.bool))
    with torch.no_grad():
        base, _ = t_tok.tokenizer_loss(tok, ttc, T(x), train_quantizer=False, **kw)
        anchored, _ = t_tok.tokenizer_loss(tok, ttc, T(x), train_quantizer=False,
                                           ema_encoder=ema, L2_lr=100.0, **kw)
        outs, _ = t_tok.pre_vq_outs(tok.encoder, ttc, T(x))
        ema_outs, _ = t_tok.pre_vq_outs(ema, ttc, T(x))
    d = ttc.make_diti().to_indices(torch.clamp(ttc.t2k * T(t), 0, 1) * 1000.0)
    k = torch.arange(ttc.k)[None, :]
    m = ((k <= d[:, None]) & (k != d[:, None])).float()[..., None]    # last active left out
    want = 100.0 * torch.mean((outs * m - ema_outs * m) ** 2)
    assert float(want) > 1e-2
    torch.testing.assert_close(anchored - base, want, rtol=1e-4, atol=1e-9)


def test_train_step_writes_the_ema_codebook_back(tiny):
    ttc, _, tree, x, noise, t = tiny
    tok = convert.tokenizer_from_jax_tree(tree, ttc)
    tc = t_trainer.TrainConfig(dit_lr=1e-3, token_lr=1e-3, ema_decay=0.5)
    state = t_trainer.make_train_state(tok, ttc, tc)
    before = {n: p.detach().clone() for n, p in tok.named_parameters()}
    T = torch.from_numpy
    state, logs = t_trainer.train_step(
        state, ttc, tc, T(x), t=T(t), noise=T(noise), drop_ids=torch.zeros(B, dtype=torch.bool),
        **_vq_draws(jax.random.PRNGKey(3), ttc))
    assert state.step == 1 and int(state.vq_state.steps) == 1 and bool(state.vq_state.initted)
    # no generator and a draw missing: the step refuses (no hidden global RNG)
    with pytest.raises(ValueError, match="rng"):
        t_trainer.train_step(state, ttc, tc, T(x), t=T(t))
    emb = tok.encoder.quantizer.embed
    assert torch.equal(emb, state.vq_state.embed)
    assert not torch.equal(emb, before[FROZEN])
    assert emb.data_ptr() != state.vq_state.embed.data_ptr()
    grads = [p.grad for _, p in t_trainer._trainable(tok)]
    np.testing.assert_allclose(float(logs["grad_norm"]), float(t_trainer.global_norm(grads)),
                               rtol=1e-6)
    for n, p in tok.named_parameters():
        if n != FROZEN:
            # the EMA copy is halfway between the old and the new weights
            torch.testing.assert_close(state.ema_params[n], 0.5 * before[n] + 0.5 * p.detach())


@pytest.mark.parametrize("exclude_opt", [False, True])
def test_kill_and_resume_follows_the_same_trajectory(tiny, tmp_path, exclude_opt):
    ttc, _, tree, x, *_ = tiny
    tc = t_trainer.TrainConfig(dit_lr=1e-3, token_lr=2e-3, warmup_steps=1, ema_decay=0.9)
    batch = torch.from_numpy(x)

    def fresh():
        return t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, tc)

    def run(state, gen, steps):
        for _ in range(steps):
            state, _ = t_trainer.train_step(state, ttc, tc, batch, rng=gen)
        return state

    # straight through: 5 steps (the optimizer rebuilt after step 3 when the
    # resumed run excludes its moments)
    gen = torch.Generator().manual_seed(0)
    straight = run(fresh(), gen, 3)
    if exclude_opt:
        straight.opt = t_trainer.make_optimizer(straight.model, tc)
    straight = run(straight, gen, 2)

    # killed after step 3, resumed from the file into a fresh state
    gen = torch.Generator().manual_seed(0)
    first = run(fresh(), gen, 3)
    path = tmp_path / "state.pt"
    t_trainer.save_train_state(path, first)
    gen_state = gen.get_state()
    del first
    resumed = t_trainer.restore_train_state(path, fresh(), exclude_opt=exclude_opt)
    assert resumed.step == 3 and int(resumed.vq_state.steps) == 3
    assert (len(resumed.opt.state) == 0) == exclude_opt
    resumed = run(resumed, torch.Generator().set_state(gen_state), 2)

    assert resumed.step == straight.step == 5
    for (n, a), b in zip(straight.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), n
    for f, a in straight.vq_state.asdict().items():
        assert torch.equal(a, getattr(resumed.vq_state, f)), f
    for n, a in straight.ema_params.items():
        assert torch.equal(a, resumed.ema_params[n]), n
