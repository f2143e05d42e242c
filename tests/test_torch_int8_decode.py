"""The int8 decode (``decode_dtype='int8'``: bf16 activations, int8 decoder
projections through ``q8_matmul``) of the PyTorch port against the JAX
pipeline's int8 decode on the CPU: same config, same carried seeded weights,
cast to bf16 and then quantized on both sides, same ids and start noise."""

import numpy as np
import pytest
import torch

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
from tests.torch_port_helpers import (
    TINY, assert_images_close, jax_decode, pipeline_pair, to_np)


@pytest.fixture(scope="module")
def int8_pair():
    jpipe, tpipe = pipeline_pair(j_load_config(TINY).to_dict(), steps=4, seed=61,
                                 decode_dtype="int8")
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 64, (2, 8))
    noise = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    return jpipe, tpipe, ids, noise


def test_int8_pipeline_quantizes_what_jax_quantizes(int8_pair):
    jpipe, tpipe, *_ = int8_pair
    assert tpipe.int8_decode and tpipe.decode_dtype == torch.bfloat16
    jm = jpipe.params["model"]
    # depth 2, hidden 128: 8 linears of the stacked block, 5 of the last,
    # final_layer.linear; the context embedder [16,128] is under the size rule
    assert "w_q" in jm["final_layer"]["linear"] and "w_q" not in jm["context_embedder"]
    names = {n for n, m in tpipe.model.named_modules() if isinstance(m, q8.Q8Linear)}
    assert len(names) == 14 and "context_embedder" not in names
    np.testing.assert_array_equal(tpipe.model.final_layer.linear.weight_q.numpy(),
                                  np.asarray(jm["final_layer"]["linear"]["w_q"]).T)


# Both sides decode in bf16 from bit-equal int8 weights, and their linears
# equal each other bit for bit on equal inputs (tests/test_torch_q8.py); the
# other bf16 operations (norms, modulation, attention, the sampler's fp32
# update of bf16 velocities) round at other places in XLA and PyTorch, and
# the per-row activation quantizer turns some of those ulps into a step of
# one quantization level. Through 4 Euler steps the latents agree to 2e-2
# of their range (measured 0.36 % at cfg 1.0, 0.92 % at cfg 2.0), against
# 1e-3 for the fp32 decode.
@pytest.mark.parametrize("cfg_scale", [None, 2.0])
def test_int8_decode_latents_match_jax(int8_pair, cfg_scale):
    jpipe, tpipe, ids, noise = int8_pair
    j_lat, j_img = jax_decode(jpipe, ids, noise, cfg_scale)
    before = q8.launch_count
    t_img, t_lat = tpipe.decoding(ids, noise=noise, cfg_scale=cfg_scale,
                                  return_latents=True)
    assert q8.launch_count == before        # CPU tensors: the plain version, uncounted
    assert tuple(t_img.shape) == (2, 64, 64, 3)
    assert float(t_img.min()) >= 0.0 and float(t_img.max()) <= 1.0
    scale = float(np.abs(j_lat).max())
    d = np.abs(to_np(t_lat) - j_lat) / scale
    print(f"cfg {cfg_scale}: latent scale {scale:.3g}, max rel diff {d.max():.4g}")
    assert d.max() <= 2e-2
    assert_images_close(tpipe.decode_latents(j_lat), j_img)
