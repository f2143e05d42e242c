"""The port's metrics (``utils/metrics.py``) against the JAX package's,
computed on the CPU, within 1e-5: PSNR and SSIM on random and on related
image pairs, the moment accumulator and the Frechet distance, Recall@K and
mAP. SSIM runs its windows with TF32 off and gives the caller's flags back."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.utils import metrics as j_m
from selftoktokenizer_tpu_torch.utils import metrics as t_m

TOL = dict(rtol=1e-5, atol=1e-5)


def _pairs(seed, shape=(3, 24, 20, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["related", "unrelated", "equal"])
def test_psnr_and_ssim_match_jax(kind):
    a, b = _pairs(0)
    if kind == "unrelated":
        b = _pairs(1)[0]
    elif kind == "equal":
        b = a.copy()
    for fn in ("psnr", "ssim"):
        want = np.asarray(getattr(j_m, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = getattr(t_m, fn)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        assert got.shape == want.shape == (3,)
        np.testing.assert_allclose(got, want, err_msg=fn, **TOL)
    if kind == "equal":
        np.testing.assert_allclose(t_m.ssim(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                                   1.0, **TOL)


def test_ssim_turns_tf32_off_inside_and_restores_the_flags():
    a, b = (torch.from_numpy(x) for x in _pairs(2, (1, 16, 16, 3)))
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return conv2d(*args, **kw)

    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(t_m.F, "conv2d", spy)
            t_m.ssim(a, b)
        assert seen and all(s == (False, False) for s in seen)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == \
            (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_streaming_moments_and_frechet_distance_match_jax():
    rng = np.random.default_rng(3)
    f1 = rng.standard_normal((40, 6))
    f2 = 0.5 + 1.3 * rng.standard_normal((50, 6))
    stats = []
    for mod in (j_m, t_m):
        m1, m2 = mod.StreamingMoments(6), mod.StreamingMoments(6)
        m1.update(f1[:25])
        m1.merge(mod.StreamingMoments(6))
        part = mod.StreamingMoments(6)
        part.update(f1[25:] if mod is j_m else torch.from_numpy(f1[25:]))
        m1.merge(part)
        m2.update(f2)
        stats.append((m1.mean_cov(), m2.mean_cov()))
    (jm1, jm2), (tm1, tm2) = stats
    for j, t in zip(jm1 + jm2, tm1 + tm2):
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm1[0], f1.mean(axis=0), rtol=1e-12, atol=1e-12)
    want = j_m.frechet_distance(*jm1, *jm2)
    got = t_m.frechet_distance(*tm1, *tm2)
    assert want > 1.0
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(t_m.frechet_distance(*tm1, *tm1), 0.0, atol=1e-5)


def test_retrieval_metrics_match_jax():
    rng = np.random.default_rng(4)
    sim = rng.standard_normal((12, 12)) + 2.0 * np.eye(12)
    for ks in ((1, 5, 10), (2, 3)):
        assert t_m.recall_at_k(sim, ks) == j_m.recall_at_k(sim, ks)
    lq, lg = rng.integers(0, 3, 12), rng.integers(0, 4, 12)
    np.testing.assert_allclose(t_m.mean_average_precision(sim, lq, lg),
                               j_m.mean_average_precision(sim, lq, lg), **TOL)
    assert t_m.mean_average_precision(sim, np.full(12, 9), lg) == 0.0
