"""The evaluation nets of the port against the JAX package's on the CPU:
Inception-V3 pool3 (rFID's features) and LPIPS-VGG16, from one seeded
state dict under the published names (torchvision / pytorch-fid, the lpips
package), read by the JAX package's ``*_from_state_dict`` and by the port's
strict loads; and from the JAX package's trees through the port's
converters. fp32 on both sides (JAX at 'highest' matmul precision)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from selftoktokenizer_tpu.eval import inception as j_inc
from selftoktokenizer_tpu.eval import lpips as j_lp
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.eval import inception as inc
from selftoktokenizer_tpu_torch.eval import lpips as lp
from tests.torch_port_helpers import seeded_inception_sd, seeded_lpips_sd, to_np

INC_TOL = dict(rtol=1e-4, atol=1e-4)
LPIPS_RTOL = 1e-5


@pytest.fixture(scope="module")
def inception_pair():
    sd = seeded_inception_sd(0)
    return j_inc.inception_from_state_dict(sd), sd


def _images(seed, b, s):
    return np.random.default_rng(seed).uniform(0, 1, (b, s, s, 3)).astype(np.float32)


@pytest.mark.parametrize("size,resize,fid_variant", [
    (96, False, True), (96, False, False), (64, True, True), (512, True, True)])
def test_inception_pool3_matches_jax(inception_pair, size, resize, fid_variant):
    params, sd = inception_pair
    x = _images(size, 2 if size == 96 else 1, size)
    want = np.asarray(j_inc.inception_pool3(params, jnp.asarray(x), fid_variant=fid_variant,
                                            resize=resize))
    model = inc.load_inception_state_dict(inc.InceptionV3Pool3(fid_variant=fid_variant), sd)
    with torch.no_grad():
        got = to_np(model(torch.from_numpy(x), resize=resize))
    assert got.shape == (x.shape[0], 2048)
    assert np.abs(want).max() > 1e-2      # the features are not vanishing
    np.testing.assert_allclose(got, want, **INC_TOL)


def test_inception_from_jax_tree(inception_pair):
    params, _ = inception_pair
    tree = {k: ({b: {n: np.asarray(a) for n, a in p.items()} for b, p in v.items()}
                if "w" not in v else {n: np.asarray(a) for n, a in v.items()})
            for k, v in params.items()}
    x = _images(3, 2, 96)
    want = np.asarray(j_inc.inception_pool3(params, jnp.asarray(x), resize=False))
    with torch.no_grad():
        got = to_np(convert.inception_from_jax_tree(tree)(torch.from_numpy(x), resize=False))
    np.testing.assert_allclose(got, want, **INC_TOL)


def test_inception_strict_load_refuses_a_missing_key():
    sd = seeded_inception_sd(1)
    del sd["Mixed_6c.branch7x7dbl_3.bn.running_mean"]
    with pytest.raises(RuntimeError, match="Mixed_6c.branch7x7dbl_3.bn.running_mean"):
        inc.load_inception_state_dict(inc.InceptionV3Pool3(), sd)


def test_lpips_matches_jax():
    sd = seeded_lpips_sd(4)
    params = j_lp.lpips_from_state_dict(sd)
    rng = np.random.default_rng(5)
    a = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    want = np.asarray(j_lp.lpips_distance(params, jnp.asarray(a), jnp.asarray(b)))
    model = lp.load_lpips_state_dict(lp.LPIPS(), sd)
    with torch.no_grad():
        got = to_np(model(torch.from_numpy(a), torch.from_numpy(b)))
        same = to_np(model(torch.from_numpy(a), torch.from_numpy(a)))
        via_tree = to_np(convert.lpips_from_jax_tree(
            {"convs": {k: {n: np.asarray(x) for n, x in p.items()}
                       for k, p in params["convs"].items()},
             "lins": {k: np.asarray(w) for k, w in params["lins"].items()}})(
                torch.from_numpy(a), torch.from_numpy(b)))
    assert np.all(want > 0)
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL, atol=0)
    np.testing.assert_allclose(via_tree, want, rtol=LPIPS_RTOL, atol=0)
    np.testing.assert_array_equal(same, 0.0)


def test_lpips_strict_load_refuses_a_missing_key():
    sd = seeded_lpips_sd(6)
    del sd["scaling_layer.scale"]
    with pytest.raises(RuntimeError, match="scaling_layer.scale"):
        lp.load_lpips_state_dict(lp.LPIPS(), sd)


def test_eval_nets_keep_the_tf32_flags():
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with torch.no_grad():
        inc.InceptionV3Pool3()(torch.rand(1, 80, 80, 3), resize=False)
        lp.LPIPS()(torch.rand(1, 32, 32, 3), torch.rand(1, 32, 32, 3))
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
