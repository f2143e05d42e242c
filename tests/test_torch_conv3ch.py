"""The plain version beside the port's ``conv3ch_3x3`` CUDA kernel against
the Pallas kernel it replaces, run in interpret mode on the CPU as
tests/test_pallas_kernels.py runs it, and against the JAX package's XLA
convolution where the Pallas kernel cannot tile the shape. The kernel itself
is held against this plain version on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.ops.conv3ch import conv3ch_3x3 as j_conv3ch
from selftoktokenizer_tpu.ops.linear import conv2d as j_conv2d
from selftoktokenizer_tpu_torch.ops import conv3ch as c3
from tests.torch_port_helpers import to_np


def _inputs(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, 3)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, C)) * 0.1).astype(np.float32)     # HWIO
    b = rng.standard_normal(C).astype(np.float32)
    return x, w, b


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


# fp32: both sides sum the 27 products in fp32 and differ in order only
# (1e-5, the tolerance of the Pallas kernel's own test); bf16: inputs and
# weights rounded to bf16 on both sides, fp32 sums, output rounded to bf16
# (the Pallas test's bf16 tolerance, tests/test_pallas_kernels.py:222-227)
@pytest.mark.parametrize("dtype,tol", [("float32", dict(rtol=1e-5, atol=1e-5)),
                                       ("bfloat16", dict(rtol=0.04, atol=0.05))])
def test_conv3ch_plain_matches_pallas_interpret(dtype, tol):
    x, w, b = _inputs(0, 2, 32, 48, 128)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_conv3ch(jnp.asarray(x, jd), jnp.asarray(w), jnp.asarray(b), rows=16,
                     interpret=True)
    got = c3.conv3ch_3x3_plain(torch.from_numpy(x).to(td), _oihw(w), torch.from_numpy(b))
    assert got.dtype == td and tuple(got.shape) == (2, 32, 48, 128)
    np.testing.assert_allclose(to_np(got), to_np(want), **tol)


def test_conv3ch_ragged_shapes_match_xla_conv():
    # H = 37, W = 29, C = 20: no tiling of the TPU kernel takes them (it
    # asserts); the port does, held against the JAX package's fp32 conv
    x, w, b = _inputs(1, 1, 37, 29, 20)
    want = j_conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = c3.conv3ch_3x3(torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)


def test_conv3ch_cpu_takes_the_plain_version_without_counting():
    x, w, b = _inputs(2, 1, 8, 8, 16)
    before = c3.launch_count
    args = (torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
    assert torch.equal(c3.conv3ch_3x3(*args), c3.conv3ch_3x3_plain(*args))
    assert c3.launch_count == before
    with pytest.raises(ValueError):
        c3.conv3ch_3x3(torch.from_numpy(x)[..., :2], _oihw(w), torch.from_numpy(b))
