"""ops/ of the PyTorch port against the JAX package's ops, fp32 on the CPU.

Same numpy inputs through both. Tolerance 1e-5 (abs and rel) throughout:
both sides compute in fp32 and differ only in summation order; the one bf16
case states its own."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from selftoktokenizer_tpu.ops import attention as jat
from selftoktokenizer_tpu.ops import linear as jlin
from selftoktokenizer_tpu.ops import norms as jnorm
from selftoktokenizer_tpu.ops import posembed as jpos
from selftoktokenizer_tpu_torch.ops import attention as tat
from selftoktokenizer_tpu_torch.ops import linear as tlin
from selftoktokenizer_tpu_torch.ops import norms as tnorm
from selftoktokenizer_tpu_torch.ops import posembed as tpos
from tests.torch_port_helpers import to_np

TOL = dict(rtol=1e-5, atol=1e-5)


def rnd(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), **(tol or TOL))


# ----------------------------------------------------------------- norms --

def test_rms_norm():
    x, w = rnd(0, 2, 5, 32), rnd(1, 32)
    close(tnorm.rms_norm(T(x), T(w)), jnorm.rms_norm(jnp.asarray(x), jnp.asarray(w)))
    close(tnorm.rms_norm(T(x)), jnorm.rms_norm(jnp.asarray(x)))


def test_layer_norm():
    x, w, b = rnd(0, 2, 5, 32), rnd(1, 32), rnd(2, 32)
    close(tnorm.layer_norm(T(x), T(w), T(b)),
          jnorm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    close(tnorm.layer_norm(T(x)), jnorm.layer_norm(jnp.asarray(x)))


def test_group_norm():
    x, w, b = rnd(0, 2, 6, 6, 64), rnd(1, 64), rnd(2, 64)
    close(tnorm.group_norm(T(x), T(w), T(b)),
          jnorm.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


def test_norm_statistics_in_fp32_for_bf16_input():
    x = rnd(3, 2, 4, 64)
    got = tnorm.layer_norm(T(x).to(torch.bfloat16))
    want = jnorm.layer_norm(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same fp32 statistics on both sides
    close(got, want, rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------- linear --

def test_linear_and_mlp():
    x = rnd(0, 2, 7, 16)
    w1, b1, w2, b2 = rnd(1, 16, 24, scale=0.3), rnd(2, 24), rnd(3, 24, 16, scale=0.3), rnd(4, 16)
    close(tlin.linear(T(x), T(w1.T), T(b1)),
          jlin.linear({"w": jnp.asarray(w1), "b": jnp.asarray(b1)}, jnp.asarray(x)))
    jp = {"fc1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
          "fc2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    close(tlin.mlp(T(x), T(w1.T), T(b1), T(w2.T), T(b2)), jlin.mlp(jp, jnp.asarray(x)))


@pytest.mark.parametrize("stride,padding,k", [(1, "SAME", 3), (1, "SAME", 1), (2, "VALID", 3)])
def test_conv2d(stride, padding, k):
    x, w, b = rnd(0, 2, 9, 9, 8), rnd(1, k, k, 8, 12, scale=0.2), rnd(2, 12)
    got = tlin.conv2d(T(x), T(w.transpose(3, 2, 0, 1)), T(b), stride=stride, padding=padding)
    want = jlin.conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
                       stride=stride, padding=padding)
    close(got, want)


def test_patch_embed_and_unpatchify():
    p, c, d = 2, 4, 16
    x, w, b = rnd(0, 2, 8, 8, c), rnd(1, p * p * c, d, scale=0.3), rnd(2, d)
    w_conv = w.reshape(p, p, c, d).transpose(3, 2, 0, 1)      # [D, C, p, p]
    close(tlin.patch_embed(T(x), T(w_conv), T(b), p),
          jlin.patch_embed({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), p))
    y = rnd(3, 2, 16, p * p * c)
    close(tlin.unpatchify(T(y), p, c, 4, 4), jlin.unpatchify(jnp.asarray(y), p, c, 4, 4))


@pytest.mark.parametrize("axis", [0, 1])
def test_modulate_and_gate(axis):
    x = rnd(0, 3, 5, 8)
    m = rnd(1, 5, 8) if axis == 0 else rnd(1, 3, 8)
    s = rnd(2, *m.shape)
    close(tlin.modulate(T(x), T(m), T(s), axis),
          jlin.modulate(jnp.asarray(x), jnp.asarray(m), jnp.asarray(s), axis))
    close(tlin.gate(T(x), T(m), axis), jlin.gate(jnp.asarray(x), jnp.asarray(m), axis))
    assert tlin.modulate(T(x), None, None) is not None and tlin.gate(T(x), None) is not None


def test_timestep_embedder():
    t = np.array([0.0, 17.5, 999.0, 1000.0], np.float32)
    w0, b0, w2, b2 = rnd(1, 256, 32, scale=0.05), rnd(2, 32), rnd(3, 32, 32, scale=0.2), rnd(4, 32)
    jp = {"mlp0": {"w": jnp.asarray(w0), "b": jnp.asarray(b0)},
          "mlp2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    close(tlin.timestep_embedder(T(t), T(w0.T), T(b0), T(w2.T), T(b2)),
          jlin.timestep_embedder(jp, jnp.asarray(t)))


# -------------------------------------------------------------- posembed --

def test_sincos_tables_equal():
    np.testing.assert_array_equal(tpos.sincos_1d(32, np.arange(9)), jpos.sincos_1d(32, np.arange(9)))
    np.testing.assert_array_equal(tpos.sincos_2d(32, 6), jpos.sincos_2d(32, 6))


def test_timestep_embedding_and_crop():
    t = np.array([0.0, 3.25, 500.0, 1000.0], np.float32)
    # cos/sin of arguments up to 1000: the two libraries' fp32 range
    # reductions differ by a few ulp of the argument
    close(tpos.timestep_embedding(T(t), 64), jpos.timestep_embedding(jnp.asarray(t), 64),
          rtol=1e-5, atol=1e-4)
    ti = np.array([1000, 1008, 5088], np.int32)
    close(tpos.timestep_embedding(T(ti), 33), jpos.timestep_embedding(jnp.asarray(ti), 33),
          rtol=1e-5, atol=1e-4)
    pe = rnd(0, 1, 36, 8)
    close(tpos.crop_pos_embed(T(pe), 6, 4, 2), jpos.crop_pos_embed(jnp.asarray(pe), 6, 4, 2))


# ------------------------------------------------------------- attention --

def qkv(seed, B=2, H=3, Lq=10, Lk=14, D=16):
    return rnd(seed, B, H, Lq, D), rnd(seed + 1, B, H, Lk, D), rnd(seed + 2, B, H, Lk, D)


def test_sdpa_plain_and_masks():
    q, k, v = qkv(0)
    J = [jnp.asarray(a) for a in (q, k, v)]
    P = [T(a) for a in (q, k, v)]
    close(tat.sdpa(*P), jat.sdpa(*J))
    bm = np.random.default_rng(5).random((2, 1, 10, 14)) > 0.3
    bm[..., 0] = True
    close(tat.sdpa(*P, mask=T(bm)), jat.sdpa(*J, mask=jnp.asarray(bm)))
    fm = rnd(6, 2, 1, 1, 14)
    close(tat.sdpa(*P, mask=T(fm)), jat.sdpa(*J, mask=jnp.asarray(fm)))


def test_sdpa_key_mask_incl_fully_masked_row():
    q, k, v = qkv(3)
    km = np.random.default_rng(7).random((2, 14)) > 0.4
    km[0, :] = False      # the finite -1e30 bias turns this into a uniform mean
    got = tat.sdpa_key_mask(T(q), T(k), T(v), T(km))
    close(got, jat.sdpa_key_mask(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km)))
    close(got[0], np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape))
    close(tat.sdpa_key_mask(T(q), T(k), T(v)), jat.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def test_sdpa_bf16_scores():
    q, k, v = qkv(8, D=64)
    km = np.random.default_rng(9).random((2, 14)) > 0.4
    km[:, 0] = True
    got = tat.sdpa_bf16_scores(*(T(a).to(torch.bfloat16) for a in (q, k, v)), key_mask=T(km))
    want = jat.sdpa_bf16_scores(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                key_mask=jnp.asarray(km))
    assert got.dtype == torch.bfloat16
    # bf16 scores and bf16 exp weights: the two sides round at the same
    # places but their matmuls accumulate differently before rounding
    close(got, want, rtol=2e-2, atol=2e-2)


def test_mha():
    q, k, v = rnd(0, 2, 6, 32), rnd(1, 2, 9, 32), rnd(2, 2, 9, 32)
    close(tat.mha(T(q), T(k), T(v), 4),
          jat.mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4))


def test_serving_attention_routes_by_head_dim():
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa

    # head dim 64 goes to the kernel's wrapper (its plain version on the CPU),
    # head dim 16 stays plain sdpa; both equal the JAX fp32 key-mask attention
    for D in (64, 16):
        q, k, v = qkv(11, D=D)
        km = np.random.default_rng(12).random((2, 14)) > 0.4
        km[:, 0] = True
        got = tat.serving_attention(T(q), T(k), T(v), T(km))
        close(got, jat.sdpa_key_mask(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(km)))
        assert fa.supported(T(q), T(k)) == (D == 64)
