"""The quantizer's training half on the CPU: the port's ``vq_train_apply``
against the reference's, on the same numpy weights, inputs and random
draws. The reference draws inside (``jax.random``); the test makes the same
draws with the keys the reference splits and hands them to the port
(``kmeans_idx``, ``react_uniforms``, ``warm_ids``, ``gumbel_noise``).

Held: quant_out, ids, loss, every VQState field, the log dict, and the
grads of loss + <quant_out, R> with respect to project_in, project_out and
x, within 1e-5 relative; ids equal."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu_torch.core.convert import vq_state_from_jax
from selftoktokenizer_tpu_torch.models import vq as t_vq
from tests.torch_port_helpers import TINY, to_np

B, K, LATENT, CODE, C, OUT = 4, 8, 32, 16, 64, 24
TOL = dict(rtol=1e-5, atol=1e-6)


def _cfg(**kw):
    cfg = dict(j_load_config(TINY).to_dict()["tokenizer"]["params"]["quantizer_config"])
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(11)
    p = {"project_in": {"w": rng.standard_normal((LATENT, CODE)).astype(np.float32) / LATENT ** 0.5,
                        "b": 0.02 * rng.standard_normal(CODE).astype(np.float32)},
         "project_out": {"w": rng.standard_normal((CODE, OUT)).astype(np.float32) / CODE ** 0.5,
                         "b": 0.02 * rng.standard_normal(OUT).astype(np.float32)}}
    e = rng.standard_normal((C, CODE)).astype(np.float32)
    p["embed"] = e / np.linalg.norm(e, axis=-1, keepdims=True)
    x = rng.standard_normal((B, K, LATENT)).astype(np.float32)
    r = rng.standard_normal((B, K, OUT)).astype(np.float32)
    return p, x, r


def _port_quantizer(p):
    m = t_vq.VectorQuantize(LATENT, CODE, C, OUT)
    with torch.no_grad():
        for n in ("project_in", "project_out"):
            getattr(m, n).weight.copy_(torch.from_numpy(p[n]["w"].T.copy()))
            getattr(m, n).bias.copy_(torch.from_numpy(p[n]["b"]))
        m._codebook.embed.copy_(torch.from_numpy(p["embed"])[None])
    return m


def _jax_step(p, state, x, r, cfg, key, gumbel=None):
    def f(pp, xx):
        q, ids, loss, st, logs = j_vq.vq_train_apply(pp, state, xx, cfg, rng=key,
                                                     gumbel_noise=gumbel)
        return loss + jnp.sum(q * r), (q, ids, loss, st, logs)

    (_, aux), grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))
    return aux, grads


def _draws(key, n, cfg, initted):
    """The reference's own draws from ``key``: _vq_quantize_body splits it
    into (rng, r_km); k-means starts from r_km, reactivation's choice draws
    its uniforms from rng; the warm-up's ids come from fold_in(key, 7919)."""
    rng, r_km = jax.random.split(key)
    d = {"react_uniforms": jax.random.uniform(rng, (C,))}
    if not initted:
        d["kmeans_idx"] = (jax.random.permutation(r_km, n)[:C] if n >= C
                           else jax.random.randint(r_km, (C,), 0, n))
    if cfg.get("continuous"):
        d["warm_ids"] = jax.random.randint(jax.random.fold_in(key, 7919), (B, K), 0, C,
                                           dtype=jnp.int32)
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _compare(weights, cfg, j_state, key, gumbel=None, expect_react=None):
    p, x, r = weights
    (jq, jids, jloss, jst, jlogs), (jgp, jgx) = _jax_step(p, j_state, x, r, cfg, key, gumbel)
    m = _port_quantizer(p)
    xt = torch.from_numpy(x).requires_grad_()
    draws = _draws(key, B * K, cfg, bool(j_state.initted))
    q, ids, loss, st, logs = t_vq.vq_train_apply(
        m, vq_state_from_jax(j_state), xt, cfg,
        gumbel_noise=None if gumbel is None else torch.from_numpy(np.array(gumbel)), **draws)
    (loss + torch.sum(q * torch.from_numpy(r))).backward()

    np.testing.assert_array_equal(to_np(ids), to_np(jids))
    np.testing.assert_allclose(to_np(q), to_np(jq), **TOL)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for f in ("embed", "cluster_size", "embed_avg", "timestep_p_over_c", "count"):
        np.testing.assert_allclose(to_np(getattr(st, f)), to_np(getattr(jst, f)), err_msg=f, **TOL)
    for f in ("steps", "initted", "tpc_initted"):
        assert int(getattr(st, f)) == int(getattr(jst, f)), f
    assert set(logs) == set(jlogs)
    for k in logs:
        np.testing.assert_allclose(float(logs[k]), float(jlogs[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(to_np(xt.grad), to_np(jgx), **TOL)
    for n in ("project_in", "project_out"):
        lin = getattr(m, n)
        np.testing.assert_allclose(to_np(lin.weight.grad).T, to_np(jgp[n]["w"]), **TOL)
        np.testing.assert_allclose(to_np(lin.bias.grad), to_np(jgp[n]["b"]), **TOL)
    if expect_react is not None:
        assert (int(logs["n_reactive"]) > 0) == expect_react
    return jst


def test_inverse_cdf_reproduces_the_reference_choice():
    key = jax.random.PRNGKey(5)
    for n, draws, seed in ((32, C, 0), (1000, 4096, 1)):
        w = np.random.default_rng(seed).random(n).astype(np.float32) ** 4
        w = w / w.sum()
        want = jax.random.choice(key, n, (draws,), p=jnp.asarray(w))
        u = jax.random.uniform(key, (draws,))
        got = t_vq.inverse_cdf(torch.from_numpy(w), torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(to_np(got), to_np(want))


def test_kmeans_init_step(weights):
    p = weights[0]
    _compare(weights, _cfg(), j_vq.vq_state_init(jax.tree_util.tree_map(jnp.asarray, p), K),
             jax.random.PRNGKey(1), expect_react=True)


def test_step_after_init_with_reactivation(weights):
    p = weights[0]
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    # the state after a k-means init on another batch of B*K = C rows, with no
    # reactivation: k-means then starts from a permutation and every code is
    # a distinct row. (A state whose reactivated codes copy rows that are
    # also k-means means holds near-identical codes, between which the ids
    # are decided by rounding.)
    x0 = np.random.default_rng(12).standard_normal((C // K, K, LATENT)).astype(np.float32)
    _, _, _, st1, _ = j_vq.vq_train_apply(jp, j_vq.vq_state_init(jp, K), jnp.asarray(x0),
                                          _cfg(dead_code_threshold=0.0),
                                          rng=jax.random.PRNGKey(1))
    assert bool(st1.initted)
    # every code's EMA count is 1 after the init, 0.99 after a step that
    # misses it: a threshold of 1.99 (absolute 0.995) reactivates the missed
    _compare(weights, _cfg(dead_code_threshold=1.99), st1, jax.random.PRNGKey(2),
             expect_react=True)


def test_continuous_warmup(weights):
    p = weights[0]
    cfg = _cfg(continuous=True, continuous_steps=2)
    jst = _compare(weights, cfg, j_vq.vq_state_init(jax.tree_util.tree_map(jnp.asarray, p), K),
                   jax.random.PRNGKey(3))
    assert int(jst.steps) == 1 and not bool(jst.initted)


def test_gumbel_sampling(weights):
    p = weights[0]
    cfg = _cfg(stochastic_sample_codes=True, sample_codebook_temp=0.5)
    u = jax.random.uniform(jax.random.PRNGKey(9), (1, B * K, C), minval=1e-20, maxval=1.0)
    _compare(weights, cfg, j_vq.vq_state_init(jax.tree_util.tree_map(jnp.asarray, p), K),
             jax.random.PRNGKey(4), gumbel=-jnp.log(-jnp.log(u)))


@pytest.mark.parametrize("smart_react", [True, False])
def test_entropy_terms_match(smart_react):
    # K = 70 positions: 64 groups of uneven size (tensor_split's rule)
    rng = np.random.default_rng(13)
    ap = rng.dirichlet(np.ones(C), 70).astype(np.float32)
    tpc = rng.dirichlet(np.ones(C), 70).astype(np.float32)
    cfg = _cfg(smart_react=smart_react)
    want = j_vq._diversity_from_apk(jnp.asarray(ap), jnp.asarray(tpc), cfg)
    got = t_vq._diversity_from_apk(torch.from_numpy(ap), torch.from_numpy(tpc), cfg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)
    np.testing.assert_allclose(
        to_np(t_vq._laplace_smoothing(torch.from_numpy(tpc[0]), C)),
        to_np(j_vq._laplace_smoothing(jnp.asarray(tpc[0]), C)), **TOL)
