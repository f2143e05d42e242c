"""The port's DDPM stack against the JAX package's on the CPU: the beta
schedules and every table within 1e-12 (float64 on both sides); q_sample,
the posteriors, p_mean_variance and the VB terms; training_losses with
respacing (the model's timesteps remapped once); the ancestral, DDIM and
reverse loops fed the noise that JAX draws from its keys, rebuilt here from
the same keys; the bits-per-dim loop; the schedule samplers' weights; and
the loss of a small DiT through the diffusion. Float32 results within 1e-5
of their scale, the loops within 1e-4."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.models import ddpm as j_dd
from selftoktokenizer_tpu.models import dit as j_dit
from selftoktokenizer_tpu.ops.posembed import sincos_2d
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import ddpm as t_dd
from selftoktokenizer_tpu_torch.models import dit as t_dit
from tests.torch_port_helpers import jax_tree, seeded_tree, to_np

TABLE_TOL = 1e-12
REL_TOL = 1e-5
LOOP_TOL = 1e-4
TABLES = ("betas", "alphas_cumprod", "alphas_cumprod_prev", "alphas_cumprod_next",
          "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
          "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod", "posterior_variance",
          "posterior_log_variance_clipped", "posterior_mean_coef1", "posterior_mean_coef2",
          "weight", "posterior_mean_jump_coef1", "posterior_mean_jump_coef2")
SHAPE = (2, 4, 4, 2)


def _rel(got, want):
    got, want = to_np(got), to_np(want)
    return np.abs(got - want).max() / np.abs(want).max()


def _pair(*a, **kw):
    return j_dd.create_diffusion(*a, **kw), t_dd.create_diffusion(*a, **kw)


def j_net(x, t, **kw):
    """A deterministic stand-in for a model: eps and the variance half,
    both depending on x and the timestep."""
    tt = t.astype(jnp.float32)[:, None, None, None] / 1000.0
    return jnp.concatenate([0.5 * jnp.sin(x + tt), jnp.tanh(0.3 * x - tt)], axis=-1)


def t_net(x, t, **kw):
    tt = t.to(torch.float32)[:, None, None, None] / 1000.0
    return torch.cat([0.5 * torch.sin(x + tt), torch.tanh(0.3 * x - tt)], dim=-1)


def _x0(seed=1, shape=SHAPE):
    return np.clip(np.random.default_rng(seed).standard_normal(shape), -1, 1).astype(np.float32)


@pytest.mark.parametrize("name", ["linear", "squaredcos_cap_v2"])
def test_named_schedules_and_tables(name):
    j = j_dd.GaussianDiffusion(betas=j_dd.get_named_beta_schedule(name, 1000),
                               model_mean_type=j_dd.ModelMeanType.EPSILON,
                               model_var_type=j_dd.ModelVarType.LEARNED_RANGE,
                               loss_type=j_dd.LossType.MSE)
    t = t_dd.GaussianDiffusion(betas=t_dd.get_named_beta_schedule(name, 1000),
                               model_mean_type=t_dd.ModelMeanType.EPSILON,
                               model_var_type=t_dd.ModelVarType.LEARNED_RANGE,
                               loss_type=t_dd.LossType.MSE)
    for n in TABLES:
        np.testing.assert_allclose(getattr(t, n), getattr(j, n), rtol=TABLE_TOL, atol=0,
                                   err_msg=n)


def test_beta_schedules_and_respacing():
    for kind in ("quad", "linear", "warmup10", "warmup50", "const", "jsd"):
        kw = dict(beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=300)
        np.testing.assert_allclose(t_dd.get_beta_schedule(kind, **kw),
                                   j_dd.get_beta_schedule(kind, **kw), rtol=TABLE_TOL, atol=0)
    for spec in ("ddim50", "250", "10,20,5", [3, 7]):
        assert t_dd.space_timesteps(1000, spec) == j_dd.space_timesteps(1000, spec)
    j, t = _pair("ddim25", diffusion_steps=500)
    assert t.timestep_map == j.timestep_map and t.num_timesteps == 25
    for n in TABLES:
        np.testing.assert_allclose(getattr(t, n), getattr(j, n), rtol=TABLE_TOL, atol=0,
                                   err_msg=n)


def test_q_sample_and_posteriors():
    j, t = _pair("", diffusion_steps=100)
    x0 = _x0()
    noise = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32)
    xt_np = np.random.default_rng(3).standard_normal(SHAPE).astype(np.float32)
    ts = np.array([0, 57])
    tt = torch.from_numpy(ts)
    ja = [jnp.asarray(a) for a in (x0, noise, xt_np, ts)]
    assert _rel(t.q_sample(torch.from_numpy(x0), tt, torch.from_numpy(noise)),
                j.q_sample(ja[0], ja[3], ja[1])) <= REL_TOL
    for got, want in zip(t.q_mean_variance(torch.from_numpy(x0), tt),
                         j.q_mean_variance(ja[0], ja[3])):
        assert _rel(got, want) <= REL_TOL
    for got, want in zip(t.q_posterior_mean_variance(torch.from_numpy(x0),
                                                     torch.from_numpy(xt_np), tt),
                         j.q_posterior_mean_variance(ja[0], ja[2], ja[3])):
        assert _rel(got, want) <= REL_TOL
    # the jump from t to target_t + 1 <= t
    ts, target = np.array([10, 57]), np.array([0, 20])
    assert _rel(t.q_posterior_mean_jump(torch.from_numpy(x0), torch.from_numpy(xt_np),
                                        torch.from_numpy(ts), torch.from_numpy(target)),
                j.q_posterior_mean_jump(ja[0], ja[2], jnp.asarray(ts),
                                        jnp.asarray(target))) <= REL_TOL


@pytest.mark.parametrize("kw", [dict(), dict(learn_sigma=False),
                                dict(learn_sigma=False, sigma_small=True),
                                dict(predict_xstart=True)],
                         ids=["learned_range", "fixed_large", "fixed_small", "start_x"])
def test_p_mean_variance_and_vb_terms(kw):
    j, t = _pair("", diffusion_steps=100, **kw)
    C = SHAPE[-1]

    def jm(x, ts, **k):
        out = j_net(x, ts)
        return out if kw.get("learn_sigma", True) else out[..., :C]

    def tm(x, ts, **k):
        out = t_net(x, ts)
        return out if kw.get("learn_sigma", True) else out[..., :C]

    x0, xt_np = _x0(), np.random.default_rng(4).standard_normal(SHAPE).astype(np.float32)
    ts = np.array([0, 63])
    want = j.p_mean_variance(jm, jnp.asarray(xt_np), jnp.asarray(ts))
    got = t.p_mean_variance(tm, torch.from_numpy(xt_np), torch.from_numpy(ts))
    for n in ("mean", "variance", "log_variance", "pred_xstart"):
        assert _rel(got[n], want[n]) <= REL_TOL, n
    want = j._vb_terms_bpd(jm, jnp.asarray(x0), jnp.asarray(xt_np), jnp.asarray(ts))
    got = t._vb_terms_bpd(tm, torch.from_numpy(x0), torch.from_numpy(xt_np),
                          torch.from_numpy(ts))
    # row 1 is a KL (t > 0); row 0 the decoder's NLL at t = 0, whose
    # discretized Gaussian takes differences of tanh near +-1 in float32
    # (the stand-in model's mean lies far from x0 under a variance of
    # 1e-4): XLA's and PyTorch's tanh differ by ulps there, up to 6e-5 of
    # the value
    assert _rel(got["output"][1], want["output"][1]) <= REL_TOL
    assert _rel(got["output"][0], want["output"][0]) <= 1e-4


@pytest.mark.parametrize("kw", [dict(), dict(use_kl=True), dict(rescale_learned_sigmas=True)],
                         ids=["mse_vb", "kl", "rescaled_mse"])
def test_training_losses_with_respacing(kw):
    j, t = _pair("25", diffusion_steps=100, **kw)
    x0 = _x0()
    noise = np.random.default_rng(5).standard_normal(SHAPE).astype(np.float32)
    ts = np.array([24, 3])
    want = j.training_losses(j_net, jnp.asarray(x0), jnp.asarray(ts), noise=jnp.asarray(noise))
    got = t.training_losses(t_net, torch.from_numpy(x0), torch.from_numpy(ts),
                            noise=torch.from_numpy(noise))
    assert set(got) == set(want)
    for n in want:
        assert _rel(got[n], want[n]) <= REL_TOL, n
    weighted = t.training_losses(t_net, torch.from_numpy(x0), torch.from_numpy(ts),
                                 noise=torch.from_numpy(noise), weighting=True)
    want = j.training_losses(j_net, jnp.asarray(x0), jnp.asarray(ts), noise=jnp.asarray(noise),
                             weighting=True)
    assert _rel(weighted["loss"], want["loss"]) <= REL_TOL


def test_respaced_vb_losses_remap_timesteps_once():
    t = t_dd.create_diffusion("25", use_kl=True, diffusion_steps=100, learn_sigma=True)
    tmap = np.asarray(t.timestep_map)
    seen = []

    def spy(x, ts, **kw):
        seen.append(ts.clone())
        return torch.zeros(x.shape[:-1] + (x.shape[-1] * 2,))

    ts = torch.tensor([24, 10])
    t.training_losses(spy, torch.randn(2, 8, 8, 4), ts, rng=torch.Generator().manual_seed(0))
    assert seen
    for s in seen:
        np.testing.assert_array_equal(s.numpy(), tmap[ts.numpy()])


def _jax_loop_noises(key, shape, n):
    """The start noise and the per-step noises of the JAX loops:
    (key, nrng) = split(key), start = normal(nrng); each step (key, sub) =
    split(key) and normal(sub)."""
    key, nrng = jax.random.split(key)
    start = np.asarray(jax.random.normal(nrng, shape))
    steps = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        steps.append(torch.from_numpy(np.array(jax.random.normal(sub, shape, jnp.float32))))
    return torch.from_numpy(start.copy()), steps


def test_p_sample_loop_with_jax_noise():
    j, t = _pair("10", diffusion_steps=100)
    key = jax.random.PRNGKey(3)
    want = j.p_sample_loop(j_net, SHAPE, key)
    start, steps = _jax_loop_noises(key, SHAPE, t.num_timesteps)
    got = t.p_sample_loop(t_net, SHAPE, noise=start, step_noises=steps)
    assert _rel(got, want) <= LOOP_TOL, _rel(got, want)
    outs = list(t.p_sample_loop_progressive(t_net, SHAPE, noise=start, step_noises=steps))
    assert len(outs) == t.num_timesteps and torch.equal(outs[-1]["sample"], got)
    # the same generator gives the same samples
    a, b = (t.p_sample_loop(t_net, SHAPE, rng=torch.Generator().manual_seed(7)) for _ in range(2))
    assert torch.equal(a, b)


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_with_jax_noise(eta):
    j, t = _pair("ddim10", diffusion_steps=100)
    key = jax.random.PRNGKey(4)
    want = j.ddim_sample_loop(j_net, SHAPE, key, eta=eta)
    start, steps = _jax_loop_noises(key, SHAPE, t.num_timesteps)
    got = t.ddim_sample_loop(t_net, SHAPE, noise=start, step_noises=steps, eta=eta)
    assert _rel(got, want) <= LOOP_TOL, _rel(got, want)


def test_bpd_and_reverse_loops():
    j, t = _pair("ddim5", diffusion_steps=100)
    x0 = _x0(6)
    key = jax.random.PRNGKey(5)
    want = j.calc_bpd_loop(j_net, jnp.asarray(x0), key)
    noises, k = [], key
    for _ in range(t.num_timesteps):
        k, sub = jax.random.split(k)
        noises.append(torch.from_numpy(np.array(jax.random.normal(sub, SHAPE, jnp.float32))))
    got = t.calc_bpd_loop(t_net, torch.from_numpy(x0), step_noises=noises)
    for n in ("total_bpd", "prior_bpd", "vb", "mse"):
        assert got[n].shape == want[n].shape and _rel(got[n], want[n]) <= LOOP_TOL, n
    want = j.ddim_reverse_sample_loop(j_net, jnp.asarray(x0))
    got = t.ddim_reverse_sample_loop(t_net, torch.from_numpy(x0))
    assert _rel(got, want) <= LOOP_TOL


def test_schedule_samplers():
    j, t = _pair("", diffusion_steps=50)
    js, ts = (m.create_named_schedule_sampler("uniform", d) for m, d in ((j_dd, j), (t_dd, t)))
    np.testing.assert_array_equal(ts.weights(), js.weights())
    for got, want in zip(ts.sample(16, np.random.default_rng(0)),
                         js.sample(16, np.random.default_rng(0))):
        np.testing.assert_array_equal(to_np(got), to_np(want))
    jl, tl = (m.create_named_schedule_sampler("loss-second-moment", d)
              for m, d in ((j_dd, j), (t_dd, t)))
    rng = np.random.default_rng(1)
    for _ in range(12):
        steps = list(range(50))
        losses = rng.uniform(0.5, 2.0, 50).tolist()
        jl.update_with_all_losses(steps, losses)
        tl.update_with_local_losses(torch.tensor(steps), torch.tensor(losses, dtype=torch.float64))
    assert tl._warmed_up()
    np.testing.assert_allclose(tl.weights(), jl.weights(), rtol=TABLE_TOL, atol=0)
    for got, want in zip(tl.sample(16, np.random.default_rng(2)),
                         jl.sample(16, np.random.default_rng(2))):
        np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6)


def test_dit_training_losses_match_jax():
    """A small learned-sigma DiT through create_diffusion's training loss
    (MSE plus the VB term in bits per dimension) on both sides."""
    kw = dict(input_size=8, patch_size=2, in_channels=4, hidden_size=48, depth=2, num_heads=4,
              num_classes=10)
    jcfg, tcfg = j_dit.DiTConfig(**kw), t_dit.DiTConfig(**kw)
    tree = seeded_tree(lambda k: j_dit.dit_init(k, jcfg), 11,
                       {("pos_embed",): sincos_2d(48, jcfg.grid)[None]})
    model = convert.dit_from_jax_tree(tree, tcfg)
    jp = jax_tree(tree)
    j, t = _pair("", diffusion_steps=1000)
    x0 = _x0(7, (2, 8, 8, 4))
    noise = np.random.default_rng(8).standard_normal(x0.shape).astype(np.float32)
    ts, y = np.array([0, 640]), np.array([3, 9])
    want = j.training_losses(lambda x, tt, **k: j_dit.dit_apply(jp, jcfg, x, tt, jnp.asarray(y)),
                             jnp.asarray(x0), jnp.asarray(ts), noise=jnp.asarray(noise))
    got = t.training_losses(
        lambda x, tt, **k: t_dit.dit_apply(model, tcfg, x, tt, torch.from_numpy(y)),
        torch.from_numpy(x0), torch.from_numpy(ts), noise=torch.from_numpy(noise))
    for n in ("loss", "mse", "vb"):
        assert _rel(got[n], want[n]) <= 1e-4, n
