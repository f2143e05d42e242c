"""The port's synthetic corpus (``tools/gen_corpus.py``) against the
reference tool: the same textures and PNG bytes for the same seed, and the
latents of ``--latents-out`` through the port's VAE carrying the JAX tool's
VAE weights (``vae_init(fold_in(PRNGKey(random_seed), 1))``) against the JAX
tool's latents file, within the bf16 rule of tests/test_torch_vae.py."""

import importlib.util
import os
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.tools import common, gen_corpus, train_tokenizer
from tests.torch_port_helpers import TINY, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SIZE = 4, 64
# bf16: each conv output rounds to bf16, and XLA and PyTorch accumulate in
# other orders before that rounding: 5e-2 of the latents' scale
# (tests/test_torch_vae.py)
BF16_TOL = 5e-2


def _root_tool():
    spec = importlib.util.spec_from_file_location(
        "root_gen_corpus", os.path.join(REPO, "tools", "gen_corpus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def root_tool():
    return _root_tool()


@pytest.mark.parametrize("seed", [0, 7])
def test_textures_and_pngs_equal_the_reference_tool(root_tool, tmp_path, seed):
    want_rng, got_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        np.testing.assert_array_equal(gen_corpus.make_texture(got_rng, SIZE),
                                      root_tool.make_texture(want_rng, SIZE))
    with mock.patch.object(sys, "argv", ["gen_corpus", "--out", str(tmp_path / "ref"),
                                         "--n", "3", "--size", str(SIZE), "--seed", str(seed)]):
        root_tool.main()
    paths, lat = gen_corpus.main(["--out", str(tmp_path / "port"), "--n", "3",
                                  "--size", str(SIZE), "--seed", str(seed)])
    assert lat is None and [os.path.basename(p) for p in paths] == sorted(
        os.listdir(tmp_path / "ref"))
    for p in paths:
        with open(p, "rb") as a, open(tmp_path / "ref" / os.path.basename(p), "rb") as b:
            assert a.read() == b.read(), p


@pytest.fixture(scope="module")
def jax_latents(root_tool, tmp_path_factory):
    """The JAX tool's --latents-out file over N textures, and the paths."""
    d = tmp_path_factory.mktemp("gen")
    out = d / "lat.npy"
    with mock.patch.object(sys, "argv", ["gen_corpus", "--out", str(d / "imgs"), "--n", str(N),
                                         "--size", str(SIZE), "--latents-out", str(out),
                                         "--yml-path", TINY, "--batch", "2"]):
        root_tool.main()
    paths = sorted(str(p) for p in (d / "imgs").iterdir())
    return np.load(out), paths


def test_latents_through_the_jax_vae_weights_match_the_jax_tool(jax_latents):
    want, paths = jax_latents
    key = jax.random.fold_in(jax.random.PRNGKey(123), 1)
    tree = jax.tree_util.tree_map(np.asarray, j_vae.vae_init(key, j_vae.VAEConfig()))
    vae = convert.vae_from_jax_tree(tree)
    got = gen_corpus.encode_paths(common.bf16_vae(vae, "cpu"), vae.cfg, paths, SIZE, 2, "cpu")
    assert got.shape == want.shape == (N, SIZE // 8, SIZE // 8, 16) and got.dtype == np.float32
    tol = BF16_TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=tol)


def test_latents_out_uses_the_seeded_vae_of_train_tokenizer(tmp_path):
    """gen_corpus --latents-out and train_tokenizer without --vae-path encode
    with one VAE: the file equals the driver's VAE's encode, bit for bit."""
    paths, lat = gen_corpus.main(["--out", str(tmp_path / "imgs"), "--n", "2", "--size",
                                  str(SIZE), "--latents-out", str(tmp_path / "lat.npy"),
                                  "--yml-path", TINY, "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "lat.npy"), lat)
    vae, cfg = train_tokenizer.load_vae(None, 123, torch.device("cpu"))
    np.testing.assert_array_equal(gen_corpus.encode_paths(vae, cfg, paths, SIZE, 2, "cpu"), lat)
    assert np.isfinite(lat).all() and to_np(lat).std() > 0


def test_the_seeded_vae_is_one_init_for_every_device_and_call():
    a, _ = common.seeded_vae(123)
    b, _ = common.seeded_vae(123)
    c, _ = common.seeded_vae(124)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.conv_in.weight"], sc["encoder.conv_in.weight"])


def test_latents_out_without_a_gpu_raises_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        gen_corpus.main(["--out", str(tmp_path / "imgs"), "--n", "1", "--size", str(SIZE),
                         "--latents-out", str(tmp_path / "lat.npy"), "--yml-path", TINY])
