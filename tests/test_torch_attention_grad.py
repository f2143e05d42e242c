"""Gradients of the attention wrapper on the CPU: the port's
``flash_sdpa_key_mask`` (an autograd Function whose forward is the kernel,
here its plain version, and whose backward is the reference's fp32
recompute) against ``jax.vjp`` of the reference's ``flash_sdpa_key_mask``
(the Pallas forward in interpret mode and its custom VJP), on the same
numpy inputs and output gradient.

Tolerances: fp32 grads within 1e-5; bf16 grads within 2e-2 of the grad's
largest magnitude (both sides cast to bf16, rounding at other places)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from selftoktokenizer_tpu.ops.flash_attention import flash_sdpa_key_mask as j_flash
from selftoktokenizer_tpu_torch.ops import flash_attention as fa
from selftoktokenizer_tpu_torch.ops import routing
from selftoktokenizer_tpu_torch.ops.attention import serving_attention
from tests.torch_port_helpers import to_np

J_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (name, dtype, B, H, Lq, Lk, D, mask kind, layout)
CASES = [
    ("fp32", torch.float32, 2, 2, 128, 192, 64, None, "dense"),
    ("fp32_masked", torch.float32, 2, 2, 128, 192, 64, "random", "dense"),
    ("bf16", torch.bfloat16, 2, 2, 128, 192, 64, None, "dense"),
    ("bf16_masked", torch.bfloat16, 2, 2, 128, 192, 64, "random", "dense"),
    ("fp32_fully_masked_row", torch.float32, 2, 2, 128, 192, 64, "full_row", "dense"),
    ("bf16_fully_masked_row", torch.bfloat16, 2, 2, 128, 192, 64, "full_row", "dense"),
    ("fp32_head_dim_128", torch.float32, 1, 2, 128, 160, 128, "random", "dense"),
    ("bf16_head_dim_128", torch.bfloat16, 1, 2, 128, 160, 128, "random", "dense"),
    ("fp32_qkv_views", torch.float32, 2, 3, 128, 128, 64, "random", "qkv"),
    ("bf16_qkv_views", torch.bfloat16, 2, 3, 128, 128, 64, None, "qkv"),
]


def _inputs(seed, dtype, B, H, Lq, Lk, D, mask_kind, layout):
    """Leaf tensors (q, k, v, or one qkv tensor), the [B,H,L,D] views the
    wrapper gets, the key mask and the output gradient."""
    rng = np.random.default_rng(seed)
    if layout == "qkv":
        leaf = torch.from_numpy(rng.standard_normal((B, Lq, 3, H, D)).astype(np.float32))
        leaf = leaf.to(dtype).requires_grad_()
        leaves = (leaf,)
        q, k, v = (leaf[:, :, i].permute(0, 2, 1, 3) for i in range(3))
        assert q.stride() == (Lq * 3 * H * D, D, 3 * H * D, 1)
    else:
        leaves = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                       .to(dtype).requires_grad_()
                       for s in ((B, H, Lq, D), (B, H, Lk, D), (B, H, Lk, D)))
        q, k, v = leaves
    mask = None
    if mask_kind is not None:
        mask = rng.random((B, Lk)) > 0.4
        mask[:, 0] = True
        if mask_kind == "full_row":
            mask[0] = False                      # batch 0: every key masked
        mask = torch.from_numpy(mask)
    do = torch.from_numpy(rng.standard_normal((B, H, Lq, D)).astype(np.float32)).to(dtype)
    return leaves, (q, k, v), mask, do


def _jax_vjp(q, k, v, mask, do, dtype):
    def j(t):
        return jnp.asarray(to_np(t), J_DTYPE[dtype])

    jm = None if mask is None else jnp.asarray(mask.numpy())
    out, vjp = jax.vjp(lambda a, b, c: j_flash(a, b, c, jm, interpret=True), j(q), j(k), j(v))
    return (out,) + vjp(j(do))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_grads_match_the_reference_vjp(case):
    name, dtype, *shape = case
    leaves, (q, k, v), mask, do = _inputs(len(name), dtype, *shape)
    out = fa.flash_sdpa_key_mask(q, k, v, mask)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
    j_out, j_dq, j_dk, j_dv = _jax_vjp(q, k, v, mask, do, dtype)
    for got, want in ((out, j_out), (dq, j_dq), (dk, j_dk), (dv, j_dv)):
        assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
        got, want = to_np(got), to_np(want)
        assert np.isfinite(got).all()
        if dtype == torch.float32:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    if shape[-2] == "full_row":
        # a row with every key masked is the uniform mean of v, with finite
        # grads (checked above, against the reference's)
        uni = v[0].float().mean(dim=1, keepdim=True).expand_as(out[0])
        assert (out[0].float() - uni).abs().max() <= (1e-6 if dtype == torch.float32 else 2e-2)
    # the grads reach the leaves: the qkv tensor's three slices, or q, k, v
    grads = torch.autograd.grad(fa.flash_sdpa_key_mask(q, k, v, mask), leaves, do)
    if len(leaves) == 1:
        for i, g in enumerate((dq, dk, dv)):
            assert torch.equal(grads[0][:, :, i], g.permute(0, 2, 1, 3))


def test_the_mask_gets_no_grad_and_counts_no_launch():
    leaves, (q, k, v), mask, do = _inputs(0, torch.float32, 1, 2, 64, 96, 64, "random", "dense")
    before = fa.launch_count
    out = fa.flash_sdpa_key_mask(q, k, v, mask)
    grads = out.grad_fn.apply(do)
    assert len(grads) == 4 and grads[3] is None
    assert fa.launch_count == before             # the CPU takes the plain version
    # without grad recording the wrapper returns a tensor with no graph
    with torch.no_grad():
        assert fa.flash_sdpa_key_mask(q, k, v, mask).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_plain_route_carries_the_same_gradient(dtype):
    leaves, (q, k, v), mask, do = _inputs(3, dtype, 2, 2, 64, 80, 64, "random", "dense")
    got = torch.autograd.grad(serving_attention(q, k, v, mask), leaves, do)
    with routing.kernel_route("plain"):
        want = torch.autograd.grad(serving_attention(q, k, v, mask), leaves, do)
    for g, w in zip(got, want):
        if dtype == torch.float32:
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
        else:
            assert (g.float() - w.float()).abs().max() <= 2e-2 * w.float().abs().max()
