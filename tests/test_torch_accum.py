"""The accumulated train step of the port on the CPU: the quantizer's two
halves (``vq_train_apply(return_extras=True)``, ``vq_microbatch_surrogate``)
and ``train_step_accum`` against the JAX package's, on the same numpy
weights, inputs and draws; and ``train_step_accum`` against the port's own
``train_step`` on the whole batch, from the same input state at every step
of a 3-step trajectory that includes the k-means init step (the reference's
own method: two trajectories that evolve apart only measure argmax chaos,
since a 1e-7 difference of reduction order flips a near-tie id a step
later).

Tolerances: against JAX, rtol 1e-5 / atol 1e-6 (loss, parameters after
the step, extras, the surrogate's outputs and gradients), the VQ state
after a step within 1e-5 of its largest value (tests/test_torch_train.py's
rule: the k-means codebook moves with the encoder's last ulps); the
accumulated step against the whole-batch step, the reference's own: VQ
state 1e-6, parameters rtol 2e-4 / atol 2e-5, loss rtol 1e-4."""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.train import trainer as j_trainer
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.convert import vq_state_from_jax
from selftoktokenizer_tpu_torch.models import tokenizer as t_tok
from selftoktokenizer_tpu_torch.models import vq as t_vq
from selftoktokenizer_tpu_torch.train import trainer as t_trainer
from tests.test_torch_vq_train import (  # noqa: F401
    B, C, K, LATENT, _cfg, _draws, _port_quantizer, weights)
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_step_draws, jax_tree, mmdit_tables, seeded_tree, to_np)

TOL = dict(rtol=1e-5, atol=1e-6)
# the diversity gate open (the usage fraction under reg[0]): g_ap non-zero
OPEN = dict(reg=[0.9, 1.0])
VQ_FIELDS = ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count")


def _initted_state(jp):
    """The state after a k-means init on another batch of B*K = C rows,
    with no reactivation (every code a distinct row)."""
    x0 = np.random.default_rng(12).standard_normal((C // K, K, LATENT)).astype(np.float32)
    return j_vq.vq_train_apply(jp, j_vq.vq_state_init(jp, K), jnp.asarray(x0),
                               _cfg(dead_code_threshold=0.0), rng=jax.random.PRNGKey(1))[3]


@pytest.mark.parametrize("initted", [False, True], ids=["kmeans-init", "initted"])
def test_return_extras_match_jax(weights, initted):  # noqa: F811
    p, x, _ = weights
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    st = _initted_state(jp) if initted else j_vq.vq_state_init(jp, K)
    cfg, key = _cfg(**OPEN), jax.random.PRNGKey(2)
    j_out = j_vq.vq_train_apply(jp, st, jnp.asarray(x), cfg, rng=key, return_extras=True)
    m = _port_quantizer(p)
    draws = _draws(key, B * K, cfg, initted)
    with torch.no_grad():
        out = t_vq.vq_train_apply(m, vq_state_from_jax(st), torch.from_numpy(x), cfg,
                                  return_extras=True, **draws)
        plain = t_vq.vq_train_apply(m, vq_state_from_jax(st), torch.from_numpy(x), cfg, **draws)
    ext, j_ext = out[5], j_out[5]
    assert set(ext) == set(j_ext) == {"embed_used", "g_ap"}
    np.testing.assert_allclose(to_np(ext["embed_used"]), to_np(j_ext["embed_used"]), **TOL)
    np.testing.assert_allclose(to_np(ext["g_ap"]), to_np(j_ext["g_ap"]), rtol=1e-5, atol=1e-6)
    assert np.abs(to_np(ext["g_ap"])).max() > 1e-4
    if initted:   # the state's codebook (on the init step: the k-means one)
        np.testing.assert_array_equal(to_np(ext["embed_used"]), to_np(st.embed))
    np.testing.assert_array_equal(to_np(out[1]), to_np(j_out[1]))
    # the first five outputs are those of the call without extras
    for a, b in zip(out[:3], plain[:3]):
        assert torch.equal(a, b)
    for f in VQ_FIELDS:
        assert torch.equal(getattr(out[3], f), getattr(plain[3], f)), f


def test_return_extras_refused_during_the_warmup(weights):  # noqa: F811
    p, x, _ = weights
    m = _port_quantizer(p)
    cfg = _cfg(continuous=True, continuous_steps=2)
    state = t_vq.vq_state_init(m, K)
    with pytest.raises(ValueError, match="warm-up"):
        t_vq.vq_train_apply(m, state, torch.from_numpy(x), cfg, return_extras=True,
                            warm_ids=torch.zeros(B, K, dtype=torch.int32))
    # after the warm-up the quantizer runs and the extras come back
    out = t_vq.vq_train_apply(m, state.replace(steps=torch.tensor(2)), torch.from_numpy(x), cfg,
                              return_extras=True, rng=torch.Generator().manual_seed(0))
    assert set(out[5]) == {"embed_used", "g_ap"}


def test_microbatch_surrogate_matches_jax(weights):  # noqa: F811
    p, x, r = weights
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    cfg, key = _cfg(**OPEN), jax.random.PRNGKey(2)
    _, ids, _, _, _, ext = j_vq.vq_train_apply(jp, _initted_state(jp), jnp.asarray(x), cfg,
                                               rng=key, return_extras=True)
    rows = slice(1, 3)
    inj = {"ids": ids[rows], "embed_used": ext["embed_used"], "g_ap": ext["g_ap"]}

    def f(pp, xx):
        q, loss, logs = j_vq.vq_microbatch_surrogate(pp, xx, inj, cfg)
        return loss + jnp.sum(q * r[rows]), (q, loss, logs)

    (_, (jq, jloss, jlogs)), (jgp, jgx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(x[rows]))
    m = _port_quantizer(p)
    xt = torch.from_numpy(x[rows]).requires_grad_()
    q, loss, logs = t_vq.vq_microbatch_surrogate(
        m, xt, {k: torch.from_numpy(np.array(v)) for k, v in inj.items()}, cfg)
    (loss + torch.sum(q * torch.from_numpy(r[rows]))).backward()

    assert np.abs(np.asarray(inj["g_ap"])).max() > 1e-4
    np.testing.assert_allclose(to_np(q), to_np(jq), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(to_np(xt.grad), to_np(jgx), **TOL)
    for n in ("project_in", "project_out"):
        lin = getattr(m, n)
        np.testing.assert_allclose(to_np(lin.weight.grad).T, to_np(jgp[n]["w"]), **TOL)
        np.testing.assert_allclose(to_np(lin.bias.grad), to_np(jgp[n]["b"]), **TOL)


@pytest.fixture(scope="module")
def tiny():
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    jtc = j_tok.tokenizer_config_from_params(params)
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 5,
                       {**encoder_tables(jtc.encoder, ("encoder",)),
                        **mmdit_tables(jtc.decoder, ("model",))})
    return t_tok.tokenizer_config_from_params(params), jtc, tree


def _batches(n, B, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, 8, 8, 16)).astype(np.float32) for _ in range(n)]


def _capture():
    """An optax stage that passes the updates on unchanged and keeps them as
    its state: chained before the optimizer, it returns the step's
    gradients."""
    import optax

    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def test_train_step_accum_matches_jax(tiny):
    ttc, jtc, tree = tiny
    x = _batches(1, 8)[0]
    # lr 1e-5 for both groups (the trainer's dit_lr): Adam's first update is
    # lr * g / (|g| + eps), so an element whose gradient is within rounding
    # of 0 moves by up to lr on either side's rounding; the gradients
    # themselves are held at test_torch_train.py's rule (1e-4 of each
    # leaf's largest value) and the parameters after the step at TOL
    tc = j_trainer.TrainConfig(dit_lr=1e-5, token_lr=1e-5)
    key = jax.random.PRNGKey(7)
    jp = jax_tree(tree)
    opt = j_trainer.optax.chain(_capture(), j_trainer.make_optimizer(jp, tc))
    j_state = j_trainer.TokenizerTrainState(
        params=jp, opt_state=opt.init(jp), vq_state=j_vq.vq_state_init(jp["encoder"]["quantizer"],
                                                                       jtc.k),
        ema_params=None, step=jnp.zeros((), jnp.int32))
    j_new, j_logs = jax.jit(lambda s, b, r: j_trainer.train_step_accum(
        s, opt, jtc, tc, b, r, n_micro=2))(j_state, jnp.asarray(x), key)

    t_tc = t_trainer.TrainConfig(**vars(tc))
    state = t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, t_tc)
    state, logs = t_trainer.train_step_accum(state, ttc, t_tc, torch.from_numpy(x), 2,
                                             **jax_step_draws(key, ttc, x.shape))
    assert state.step == 1 and bool(state.vq_state.initted)
    assert set(logs) - {"ids"} == set(j_logs)
    for k in j_logs:
        np.testing.assert_allclose(float(logs[k]), float(j_logs[k]), err_msg=k, **TOL)
    for f in VQ_FIELDS:    # as tests/test_torch_train.py: within 1e-5 of the largest value
        got, want = to_np(getattr(state.vq_state, f)), to_np(getattr(j_new.vq_state, f))
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), f
    codebook = "encoder.quantizer._codebook.embed"     # the VQ state's, held above
    assert torch.equal(state.model.get_parameter(codebook)[0], state.vq_state.embed)
    # no clipping: .grad still holds the averaged gradients of the step
    grads = convert.tokenizer_state_dict(jax.tree_util.tree_map(np.asarray, j_new.opt_state[0]),
                                         ttc)
    want = convert.tokenizer_state_dict(jax.tree_util.tree_map(np.asarray, j_new.params), ttc)
    for n, p in state.model.named_parameters():
        if n == codebook:
            continue
        g, w = to_np(p.grad), grads[n].numpy()
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max() or np.abs(g - w).max() <= 1e-10, n
        np.testing.assert_allclose(to_np(p), want[n].numpy(), err_msg=n, **TOL)


def _assert_steps_agree(a, b, la, lb, what):
    for f in VQ_FIELDS:
        np.testing.assert_allclose(to_np(getattr(a.vq_state, f)), to_np(getattr(b.vq_state, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f"{what}: vq_state.{f}")
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(to_np(p), to_np(q), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{what}: {n}")
    np.testing.assert_allclose(float(la["loss"]), float(lb["loss"]), rtol=1e-4, err_msg=what)
    # Adam's step is blind to a gradient's scale: the norm is not
    np.testing.assert_allclose(float(la["grad_norm"]), float(lb["grad_norm"]), rtol=1e-4,
                               err_msg=what)
    np.testing.assert_allclose(float(la["vq_perplexity"]), float(lb["vq_perplexity"]),
                               rtol=1e-5, err_msg=what)
    np.testing.assert_array_equal(to_np(la["ids"]), to_np(lb["ids"]), err_msg=what)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_accum_equals_the_whole_batch_step(tiny, n_micro):
    ttc, _, tree = tiny
    tc = t_trainer.TrainConfig(dit_lr=3e-4, token_lr=1e-3, grad_norm=1.0)
    state = t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, tc)
    key = jax.random.PRNGKey(3)
    for i, x in enumerate(_batches(3, 16, seed=5)):
        draws = jax_step_draws(jax.random.fold_in(key, i), ttc, x.shape)
        acc = copy.deepcopy(state)
        state, logs = t_trainer.train_step(state, ttc, tc, torch.from_numpy(x), **draws)
        acc, logs_a = t_trainer.train_step_accum(acc, ttc, tc, torch.from_numpy(x), n_micro,
                                                 **draws)
        assert acc.step == state.step == i + 1
        _assert_steps_agree(acc, state, logs_a, logs, f"step {i}")
        assert torch.equal(acc.model.encoder.quantizer.embed, acc.vq_state.embed)


def test_accum_scales_the_reactivation_threshold_by_the_global_batch(tiny):
    """The dead-code threshold is relative to the global tokens per step:
    after the init step a reactivated code holds reset * (B*K / C) as its
    EMA count, with B the global batch for the accumulated step."""
    ttc, _, tree = tiny
    # threshold 1.0: a code with fewer than B*K/C members after the init dies
    # (reset stays at 0.2, under every living code's count)
    ttc = dataclasses.replace(ttc, quantizer={**ttc.quantizer, "dead_code_threshold": 1.0})
    tc = t_trainer.TrainConfig()
    q = ttc.quantizer
    x = _batches(1, 16, seed=5)[0]
    key = jax.random.PRNGKey(3)
    big = t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, tc)
    small = t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, tc)
    big, lb = t_trainer.train_step_accum(big, ttc, tc, torch.from_numpy(x), 4,
                                         **jax_step_draws(key, ttc, x.shape))
    small, ls = t_trainer.train_step(small, ttc, tc, torch.from_numpy(x[:4]),
                                     **jax_step_draws(key, ttc, x[:4].shape))
    assert int(lb["vq_n_reactive"]) > 0 and int(ls["vq_n_reactive"]) > 0
    reset, C = q["reset_cluster_size"], q["codebook_size"]
    np.testing.assert_allclose(float(big.vq_state.cluster_size.min()), reset * 16 * ttc.k / C,
                               rtol=1e-4)
    np.testing.assert_allclose(float(small.vq_state.cluster_size.min()), reset * 4 * ttc.k / C,
                               rtol=1e-4)


def test_accum_refuses_a_batch_that_does_not_split(tiny):
    ttc, _, tree = tiny
    tc = t_trainer.TrainConfig()
    state = t_trainer.make_train_state(convert.tokenizer_from_jax_tree(tree, ttc), ttc, tc)
    with pytest.raises(ValueError, match="multiple of n_micro"):
        t_trainer.train_step_accum(state, ttc, tc, torch.zeros(6, 8, 8, 16), 4,
                                   rng=torch.Generator())
    with pytest.raises(ValueError, match="rng"):
        t_trainer.train_step_accum(state, ttc, tc, torch.zeros(4, 8, 8, 16), 2)
