"""The SD3 VAE of the PyTorch port against the JAX package, narrow
(ch=32) on the CPU, with carried seeded weights."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.models import vae as t_vae
from tests.torch_port_helpers import jax_tree, seeded_tree, to_np


@pytest.fixture(scope="module")
def vae_pair():
    jcfg = j_vae.VAEConfig(ch=32)
    tree = seeded_tree(lambda k: j_vae.vae_init(k, jcfg), 3)
    vae = convert.vae_from_jax_tree(tree, t_vae.VAEConfig(ch=32))
    rng = np.random.default_rng(4)
    img = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    lat = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    return jcfg, jax_tree(tree), vae, img, lat


# fp32: convs, group norms and the mid attention in fp32 on both sides, 1e-4;
# bf16: every conv output rounds to bf16 and XLA and PyTorch accumulate
# differently before that rounding: 5e-2 of the output's scale (the decoder's
# output reaches 1.8 with these weights, and each side's bf16 result lies
# 0.065-0.07 from its own fp32 result, so 5e-2 absolute is below the noise)
def _tol(tol, want):
    return tol * max(1.0, float(np.abs(to_np(want)).max())) if tol > 1e-3 else tol


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_vae_encode_mode(vae_pair, dtype, tol):
    jcfg, jp, vae, img, _ = vae_pair
    want = j_vae.vae_encode_mode(jp, jcfg, jnp.asarray(img, getattr(jnp, dtype)))
    with torch.no_grad():
        got = t_vae.vae_encode_mode(vae, vae.cfg, torch.from_numpy(img).to(getattr(torch, dtype)))
    assert tuple(got.shape) == (2, 4, 4, 16) and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=_tol(tol, want))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_vae_decode(vae_pair, dtype, tol):
    jcfg, jp, vae, _, lat = vae_pair
    want = j_vae.vae_decode(jp, jcfg, jnp.asarray(lat, getattr(jnp, dtype)))
    with torch.no_grad():
        got = t_vae.vae_decode(vae, vae.cfg, torch.from_numpy(lat).to(getattr(torch, dtype)))
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=_tol(tol, want))


def test_vae_moments_and_latent_format(vae_pair):
    jcfg, jp, vae, img, lat = vae_pair
    jm, jl = j_vae.vae_encode_moments(jp, jcfg, jnp.asarray(img))
    with torch.no_grad():
        tm, tl = t_vae.vae_encode_moments(vae, vae.cfg, torch.from_numpy(img))
    np.testing.assert_allclose(to_np(tm), to_np(jm), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-4)
    f = t_vae.SD3LatentFormat
    np.testing.assert_allclose(
        to_np(f.process_out(f.process_in(torch.from_numpy(lat)))), lat, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(f.process_in(torch.from_numpy(lat))),
                               to_np(j_vae.SD3LatentFormat.process_in(jnp.asarray(lat))),
                               rtol=1e-6, atol=1e-6)
