"""The plain versions beside the port's two CUDA kernels against the Pallas
kernels they replace, run in interpret mode on the CPU (as
tests/test_pallas_kernels.py runs them).

The CUDA kernels themselves cannot run here; chip_smoke.py holds them
against these plain versions on the card."""

import subprocess
import sys
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.ops.attention import sdpa_key_mask as j_sdpa_key_mask
from selftoktokenizer_tpu.ops.flash_attention import flash_sdpa_key_mask as j_flash
from selftoktokenizer_tpu.ops.vq_kernels import vq_argmax as j_vq_argmax
from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from selftoktokenizer_tpu_torch.ops import vq_kernels as vk
from tests.torch_port_helpers import to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def T(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def qkv(seed, B, H, Lq, Lk, D=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Lq, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32),
            rng.standard_normal((B, H, Lk, D)).astype(np.float32))


def key_mask(seed, B, Lk):
    m = np.random.default_rng(seed).random((B, Lk)) > 0.4
    m[:, 0] = True
    return m


# fp32: both sides are fp32 throughout and differ in summation order only
# (2e-5, the tolerance of the Pallas kernel's own tests); bf16: products of
# bf16 values accumulated in fp32 on both sides, weights rounded to bf16
# before P V, output rounded to bf16 (2e-2, likewise)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_plain_matches_pallas_interpret(dtype, tol, masked):
    q, k, v = qkv(0, 2, 3, 128, 256)
    km = key_mask(1, 2, 256) if masked else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = j_flash(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
                   None if km is None else jnp.asarray(km), interpret=True)
    got = fa.flash_sdpa_key_mask_plain(T(q, td), T(k, td), T(v, td),
                                       None if km is None else T(km))
    assert got.dtype == td and tuple(got.shape) == (2, 3, 128, 64)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)


def test_flash_plain_fully_masked_row_is_uniform_mean():
    q, k, v = qkv(2, 2, 2, 128, 128)
    km = key_mask(3, 2, 128)
    km[0, :] = False
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km),
                   interpret=True)
    got = fa.flash_sdpa_key_mask_plain(T(q), T(k), T(v), T(km))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)
    uniform = np.broadcast_to(v[0].mean(axis=1, keepdims=True), (2, 128, 64))
    np.testing.assert_allclose(to_np(got)[0], uniform, rtol=2e-5, atol=2e-5)


def test_flash_plain_lengths_the_pallas_kernel_cannot_tile():
    # Lq = 200 and Lk = 333 divide by no block of the TPU kernel, which
    # asserts; the port accepts them, held against the JAX fp32 reference
    q, k, v = qkv(4, 2, 3, 200, 333)
    km = key_mask(5, 2, 333)
    want = j_sdpa_key_mask(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km))
    got = fa.flash_sdpa_key_mask(T(q), T(k), T(v), T(km))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)


def unit_rows(seed, n, d=16):
    a = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def test_vq_argmax_plain_matches_pallas_interpret_ragged_n():
    z, e = unit_rows(0, 500), unit_rows(1, 4096)     # N not a multiple of 256
    want = np.asarray(j_vq_argmax(jnp.asarray(z), jnp.asarray(e), interpret=True))
    got = vk.vq_argmax_plain(T(z), T(e))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_vq_argmax_plain_identical_codes_give_id_zero():
    z = unit_rows(2, 300)
    e = np.repeat(unit_rows(3, 1), 4096, axis=0)
    want = np.asarray(j_vq_argmax(jnp.asarray(z), jnp.asarray(e), interpret=True))
    got = vk.vq_argmax_plain(T(z), T(e)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


def test_vq_argmax_plain_duplicate_codes_give_lowest_id():
    z = unit_rows(4, 300)
    base = unit_rows(5, 2048)
    e = np.concatenate([base, base])                  # code c and c + 2048 are equal
    want = np.asarray(j_vq_argmax(jnp.asarray(z), jnp.asarray(e), interpret=True))
    got = vk.vq_argmax_plain(T(z), T(e)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() < 2048


def test_wrappers_take_the_plain_version_on_cpu_and_do_not_count():
    q, k, v = qkv(6, 1, 2, 64, 96)
    n_fa, n_vk = fa.launch_count, vk.launch_count
    out = fa.flash_sdpa_key_mask(T(q), T(k), T(v))
    assert torch.equal(out, fa.flash_sdpa_key_mask_plain(T(q), T(k), T(v)))
    z, e = unit_rows(7, 50), unit_rows(8, 333)
    assert torch.equal(vk.vq_argmax(T(z), T(e)), vk.vq_argmax_plain(T(z), T(e)))
    assert (fa.launch_count, vk.launch_count) == (n_fa, n_vk)


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k, v = qkv(9, 1, 2, 64, 96)
    with pytest.raises(ValueError):
        fa.flash_sdpa_key_mask(T(q).requires_grad_(), T(k), T(v))      # forward only
    with pytest.raises(ValueError):
        fa.flash_sdpa_key_mask(T(q), T(k), T(v), torch.ones(1, 95, dtype=torch.bool))
    with pytest.raises(ValueError):
        fa.flash_sdpa_key_mask(T(q), T(k), T(v)[:, :, :50])
    with pytest.raises(ValueError):
        vk.vq_argmax(T(unit_rows(0, 4)), T(unit_rows(1, 8, d=8)))


def test_kernel_modules_import_without_triton_or_nvcc():
    code = (
        "import sys\n"
        "sys.modules['triton'] = None\n"          # any 'import triton' would raise
        "import selftoktokenizer_tpu_torch.ops.flash_attention as fa\n"
        "import selftoktokenizer_tpu_torch.ops.vq_kernels as vk\n"
        "import selftoktokenizer_tpu_torch.ops._build as b\n"
        "assert fa.launch_count == 0 and vk.launch_count == 0 and not b._libs\n"
        "print('imported')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, PATH="/nonexistent")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "imported" in out.stdout
