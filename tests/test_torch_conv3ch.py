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


def _c_sizes():
    """csrc/conv3ch.cu's one-line size functions (row_stride .. smem_bytes)
    and constants, translated from the source text: C's integer division,
    casts, logic and one-level conditionals written for Python."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "selftoktokenizer_tpu_torch", "csrc", "conv3ch.cu")).read()
    env = {name: int(val) for name, val in
           re.findall(r"constexpr (?:int|size_t) (\w+) = (\d+);", src)}
    env["WARPS"] = env["THREADS"] // 32
    fns = re.findall(r"__forceinline__ (?:int|size_t) (\w+)\(([^)]*)\) \{ return ([^;]+); \}", src)
    for name, args, body in fns:
        params = ", ".join(a.split()[-1] for a in args.split(","))
        expr = body.replace("(size_t)", "").replace("/", "//")
        expr = expr.replace("||", " or ").replace("&&", " and ")
        cond = re.fullmatch(r"(.+?) \? (.+?) : (.+)", expr)
        if cond:
            expr = f"({cond[2]}) if ({cond[1]}) else ({cond[3]})"
        env[name] = eval(f"lambda {params}: {expr}", env)
    assert {"row_stride", "smem_bf16", "stage_channels", "f32_chunks", "smem_f32",
            "smem_bytes"} <= set(env)
    return env


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3ch_smem_of_the_card_cases_fits_a_block(dtype):
    k = _c_sizes()
    assert k["SMEM_LIMIT"] == c3.SMEM_LIMIT
    bf16 = dtype == torch.bfloat16
    # the VAE's conv_in, the widest width, and the wide-channel cases of the
    # card check fit a block
    for W, C in ((256, 128), (257, 256), (20, 1500), (37, 1000)):
        assert k["smem_bytes"](W, C, bf16) <= c3.SMEM_LIMIT, (W, C)
    if bf16:
        # the VAE stores whole 16 x C tiles, C = 1000 64 channels at a time
        assert k["stage_channels"](256, 128) == 128 and k["stage_channels"](37, 1000) == 64
    else:
        # one turn over the channel groups up to 1024 channels, two at 1500
        assert k["f32_chunks"](1024) == 1 and k["f32_chunks"](1500) == 2
        # with one turn the bands reuse the weight table's space
        assert k["smem_f32"](256, 128) == max(27 * 128 * 4, 24 * k["row_stride"](256))


def _earlier_kernel_smem(W, C):
    # the kernel this one replaced: a band of 6 rows of W + 2 fp32 pixels
    # (rounded up to 4 floats), then 27 weights and the bias for C rounded up
    # to 8, all fp32, in either type of x
    return 4 * ((6 * (W + 2) * 3 + 3) // 4 * 4 + 28 * (-(-C // 8) * 8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3ch_takes_every_shape_the_earlier_kernel_took(dtype):
    k = _c_sizes()
    bf16 = dtype == torch.bfloat16
    lim = c3.SMEM_LIMIT
    fits = lambda W, C: k["smem_bytes"](W, C, bf16) <= lim
    # the earlier kernel's widest W at one channel, and its most channels at
    # each width: the edges of what it took
    w_max = max(W for W in range(1, 4000) if _earlier_kernel_smem(W, 1) <= lim)
    assert fits(w_max, 1)
    for W in (1, 2, 3, 29, 31, 256, 257, 1000, 1600, 2000, 3000, w_max):
        c_max = max(C for C in range(1, 2200, 1) if _earlier_kernel_smem(W, C) <= lim)
        for C in (1, 3, 8, 20, 128, 1024, 1025, c_max):
            if C <= c_max:
                assert fits(W, C), (W, C)


@pytest.mark.parametrize("B,H,W,C", [(1, 1, 31, 20), (2, 5, 257, 256), (3, 2, 1, 8)])
def test_conv3ch_plain_ragged_widths_match_xla_conv(B, H, W, C):
    # the card check's ragged widths, a single row and C = 256, held here
    # against the JAX package's fp32 conv through the plain version
    x, w, b = _inputs(B + W, B, H, W, C)
    want = j_conv2d({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
    got = c3.conv3ch_3x3(torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5, atol=1e-5)
