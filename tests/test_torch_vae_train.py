"""The SD3 VAE's trainer of the port on the CPU against the JAX package's,
on a narrow VAE (ch 32, ch_mult (1, 2), one res block, 32 px), the same
seeded weights carried into the port (``vae_from_jax_tree``) and JAX's
reparametrisation noise passed in.

- ``vae_loss`` in bf16 (its type): the loss terms against JAX's bf16 terms
  within the bf16 rule of tests/test_torch_vae.py (5e-2, times the value
  where it exceeds 1); each gradient leaf against the exact gradient
  (JAX's, run in fp32) within 5e-2 of the leaf's scale plus 1e-3 of the
  largest gradient. JAX's own bf16 gradient is not the yardstick: it sums
  the bias gradients in bf16 and lies up to 27 % of a leaf's scale from
  the exact one (the port's under 1 % there).
- Two ``vae_train_step``s in fp32 (the reference run in fp32 by handing its
  module a ``jnp`` whose bfloat16 is float32, the port by setting its
  ``COMPUTE_DTYPE`` to float32): the loss terms and the
  gradient norm within 1e-5 at each step, each gradient leaf (captured by
  an optax stage that keeps the step's gradients) within 1e-4 of
  max(leaf scale, 1e-3 of the largest gradient), and the parameters after
  the steps within rtol 1e-5 / atol 1e-6. The exception are the elements
  whose gradient lies within that tolerance of 0 at either step (mostly
  conv biases before a GroupNorm and the attention's key bias, whose
  gradients are rounding noise): Adam normalises each update, so such an
  element moves by up to lr either way, and it is held within the sum of
  the steps' rates (tests/test_torch_train_optimizer.py feeds its
  optimizers one gradient for the same reason).
- The learning rate of each update against JAX's optimizer (constant unit
  gradients: Adam's step is then the rate itself); the loss falls over five
  steps; ``save_vae_state`` / ``load_vae_params`` round-trip; the
  evaluation's PSNR and SSIM against JAX's (bf16 rule).
"""

from unittest import mock

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu.train import vae as j_tv
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import vae as t_vae
from selftoktokenizer_tpu_torch.train import vae as t_tv
from tests.torch_port_helpers import jax_tree, seeded_tree, to_np

WIDTHS = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
LATENT = (2, 16, 16, 16)


class _F32Numpy:
    """jax.numpy with bfloat16 standing for float32: the reference's VAE
    trainer, which casts to bfloat16 by name, then runs in fp32."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


def _fp32_reference():
    return mock.patch.object(j_tv, "jnp", _F32Numpy())


def _fp32_port():
    """The port's VAE trainer with its compute type set to float32."""
    return mock.patch.object(t_tv, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture(scope="module")
def pair():
    jcfg = j_vae.VAEConfig(**WIDTHS)
    tree = seeded_tree(lambda k: j_vae.vae_init(k, jcfg), 3)
    img = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    return jcfg, t_vae.VAEConfig(**WIDTHS), tree, img


def _noise(key):
    return torch.from_numpy(np.array(jax.random.normal(key, LATENT, jnp.float32)))


def _sd(tree):
    """A JAX VAE tree -> {reference name: numpy array}."""
    return {k: to_np(v) for k, v in
            convert.vae_state_dict(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _jax_loss_and_grads(jcfg, tree, img, key, tc):
    f = jax.jit(jax.value_and_grad(lambda p, x: j_tv.vae_loss(p, jcfg, x, key, tc), has_aux=True))
    (_, logs), grads = f(jax_tree(tree), jnp.asarray(img))
    return logs, _sd(grads)


def _bf16_tol(want):
    return 5e-2 * max(1.0, abs(float(want)))


def test_vae_loss_and_grads_match_jax_in_bf16(pair):
    jcfg, tcfg, tree, img = pair
    tc, key = j_tv.VAETrainConfig(), jax.random.PRNGKey(0)
    j_logs, j_grads = _jax_loss_and_grads(jcfg, tree, img, key, tc)
    with _fp32_reference():
        _, exact = _jax_loss_and_grads(jcfg, tree, img, key, tc)
    vae = convert.vae_from_jax_tree(tree, tcfg)
    loss, logs = t_tv.vae_loss(vae, tcfg, torch.from_numpy(img), t_tv.VAETrainConfig(),
                               noise=_noise(key))
    loss.backward()
    assert set(logs) == set(j_logs)
    for k, v in logs.items():
        assert abs(float(v) - float(j_logs[k])) <= _bf16_tol(j_logs[k]), k
    top = max(np.abs(g).max() for g in exact.values())
    j_worst = max(np.abs(j_grads[n] - exact[n]).max() / np.abs(exact[n]).max() for n in exact)
    assert j_worst > 0.2          # the reference's bf16 bias sums: see above
    for n, p in vae.named_parameters():
        assert p.grad is not None and p.grad.dtype == torch.float32, n
        err = np.abs(to_np(p.grad) - exact[n]).max()
        assert err <= 5e-2 * np.abs(exact[n]).max() + 1e-3 * top, (n, err)


def _capture():
    """An optax stage that passes the updates on and keeps them as its
    state: chained before the optimizer, it returns the step's gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))


def test_two_train_steps_match_jax_in_fp32(pair):
    jcfg, tcfg, tree, img = pair
    kw = dict(lr=1e-4, warmup_steps=0, max_steps=10)
    jtc, tc = j_tv.VAETrainConfig(**kw), t_tv.VAETrainConfig(**kw)
    opt = optax.chain(_capture(), j_tv.make_vae_optimizer(jtc))
    jp = jax_tree(tree)
    j_state = j_tv.VAETrainState(params=jp, opt_state=opt.init(jp), step=jnp.zeros((), jnp.int32))
    state = t_tv.make_vae_train_state(convert.vae_from_jax_tree(tree, tcfg), tc)
    noise = {}      # elements whose gradient is within its tolerance of 0
    with _fp32_reference(), _fp32_port():
        step = jax.jit(lambda s, b, r: j_tv.vae_train_step(s, opt, jcfg, jtc, b, r))
        for i in range(2):
            key = jax.random.PRNGKey(10 + i)
            j_state, j_logs = step(j_state, jnp.asarray(img), key)
            state, logs = t_tv.vae_train_step(state, tcfg, tc, torch.from_numpy(img),
                                              noise=_noise(key))
            assert set(logs) == set(j_logs)
            for k, v in logs.items():
                np.testing.assert_allclose(float(v), float(j_logs[k]), rtol=1e-5, atol=1e-7,
                                           err_msg=f"step {i}: {k}")
            grads = _sd(j_state.opt_state[0])
            top = max(np.abs(g).max() for g in grads.values())
            for n, p in state.model.named_parameters():
                # grad_norm 1.0 clips in place: compare the unclipped gradient
                g = to_np(p.grad) * max(float(logs["grad_norm"]), 1.0)
                tol = 1e-4 * max(np.abs(grads[n]).max(), 1e-3 * top)
                assert np.abs(g - grads[n]).max() <= tol, (i, n)
                noise[n] = noise.get(n, False) | (np.abs(grads[n]) <= tol)
    assert state.step == 2
    n_noise = sum(int(m.sum()) for m in noise.values())
    assert 0 < n_noise < 0.01 * sum(m.size for m in noise.values()), n_noise
    want, before = _sd(j_state.params), _sd(tree)
    lr_sum = (t_tv.vae_lr_at(tc, 0) + t_tv.vae_lr_at(tc, 1)) * (1 + 1e-5)
    for n, p in state.model.named_parameters():
        got, m = to_np(p), noise[n]
        assert np.all(np.abs(got - before[n])[m] <= lr_sum), n
        np.testing.assert_allclose(got[~m], want[n][~m], rtol=1e-5, atol=1e-6, err_msg=n)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=3, max_steps=12),
                                dict(warmup_steps=50, max_steps=20, end_lr_ratio=0.3),
                                dict(warmup_steps=0, max_steps=6)],
                         ids=["default", "warmup3", "warmup-clamped", "no-warmup"])
def test_learning_rate_of_each_update_matches_jax(kw):
    # the schedule the reference hands its Adam, evaluated at the update's
    # count before the increment (the fp32 steps above hold that count)
    seen = []
    adam = optax.adam
    with mock.patch.object(j_tv.optax, "adam", lambda lr, **k: seen.append(lr) or adam(lr, **k)):
        j_tv.make_vae_optimizer(j_tv.VAETrainConfig(**kw))
    sched, = seen
    tc = t_tv.VAETrainConfig(**kw)
    for step in (0, 1, 2, 3, 5, 9, 17, 49, 50, 51, 1000, 19999, 20000, 25000):
        # optax evaluates in fp32: its warmup loses ulps of the peak rate
        np.testing.assert_allclose(t_tv.vae_lr_at(tc, step), float(sched(step)), rtol=1e-6,
                                   atol=1e-6 * tc.lr, err_msg=f"{kw} step {step}")


def _images(seed, n=4, size=32):
    """Smooth colour ramps with a hard-edged rectangle: structure a small
    VAE reduces its loss on within a few steps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij")
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        c0, c1 = rng.uniform(-1, 1, (2, 3))
        img = c0 + (c1 - c0) * ((xx + yy + 2) / 4)[..., None]
        x0, y0 = rng.integers(0, size // 2, 2)
        img[y0:y0 + 8, x0:x0 + 8] = rng.uniform(-1, 1, 3)
        out[i] = np.clip(img, -1, 1)
    return torch.from_numpy(out)


def test_the_loss_falls_over_five_steps(pair):
    _, tcfg, tree, _ = pair
    tc = t_tv.VAETrainConfig(lr=1e-3, warmup_steps=1, max_steps=100)
    state = t_tv.make_vae_train_state(convert.vae_from_jax_tree(tree, tcfg), tc)
    batch, gen = _images(1), torch.Generator().manual_seed(0)
    losses = []
    for _ in range(5):
        state, logs = t_tv.vae_train_step(state, tcfg, tc, batch, rng=gen)
        losses.append(float(logs["loss"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    with pytest.raises(ValueError, match="noise or rng"):
        t_tv.vae_train_step(state, tcfg, tc, batch)


def test_save_and_load_round_trip(pair, tmp_path):
    jcfg, tcfg, tree, img = pair
    tc = t_tv.VAETrainConfig(lr=1e-3, warmup_steps=0, max_steps=10)
    state = t_tv.make_vae_train_state(convert.vae_from_jax_tree(tree, tcfg), tc)
    state, _ = t_tv.vae_train_step(state, tcfg, tc, torch.from_numpy(img),
                                   rng=torch.Generator().manual_seed(1))
    path = tmp_path / "vae.pt"
    t_tv.save_vae_state(path, state, tcfg)
    vae, cfg = t_tv.load_vae_params(path)
    assert cfg == tcfg
    for (n, a), b in zip(state.model.state_dict().items(), vae.state_dict().values()):
        assert torch.equal(a, b), n
    x = torch.from_numpy(img)
    assert [float(v) for v in t_tv.vae_eval_psnr(vae, cfg, x)] == \
        [float(v) for v in t_tv.vae_eval_psnr(state.model, tcfg, x)]


def test_eval_psnr_and_ssim_match_jax(pair):
    jcfg, tcfg, tree, img = pair
    j_psnr, j_ssim = j_tv.vae_eval_psnr(jax_tree(tree), jcfg, jnp.asarray(img))
    psnr, ssim = t_tv.vae_eval_psnr(convert.vae_from_jax_tree(tree, tcfg), tcfg,
                                    torch.from_numpy(img))
    # bf16 encode and decode on both sides: the images agree within the bf16 rule
    assert abs(float(psnr) - float(j_psnr)) <= 5e-2 * abs(float(j_psnr))
    assert abs(float(ssim) - float(j_ssim)) <= _bf16_tol(j_ssim)
