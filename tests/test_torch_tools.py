"""The port's tools on the CPU, driven in process through ``main(argv)``
on ``tests/data/tiny-eval.yml`` with a tokenizer ``.pth`` (the JAX
package's exporter on a seeded tree) and a VAE ``.pt`` (ch=32), the same
files loaded by the JAX pipeline:

* ``tokenize_corpus`` over a folder and over tar shards: each row's ids
  equal the port pipeline's own encode of that row's pixels (same batches),
  the JAX encoder's on the port's latents under the 1e-6 top-2 margin rule,
  and JAX's ``SelftokPipeline.encoding`` of the same pixels under the bf16
  VAE rule of tests/test_torch_pipeline.py; two gloo ranks write parts that
  the reference's ``tools/merge_token_parts.py`` merges into the one-rank
  file; ``--limit`` and ``--margin-stats``;
* ``eval_recon``'s loop against JAX's ``psnr``, ``ssim``, ``lpips_distance``
  and ``frechet_distance`` (over ``inception_pool3``) on the same arrays;
* ``smoke`` writes its PNG; ``encode_corpus``'s latents and sidecar."""

import functools
import importlib.util
import json
import os
import tarfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import selftoktokenizer_tpu.pipeline.pipeline as j_pipeline_mod
from selftoktokenizer_tpu.core import export as j_export
from selftoktokenizer_tpu.core.config import AttrDict as JAttrDict
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.eval import inception as j_inc
from selftoktokenizer_tpu.eval import lpips as j_lp
from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu.pipeline import SelftokPipeline as JaxPipeline
from selftoktokenizer_tpu.utils import metrics as j_metrics
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import AttrDict
from selftoktokenizer_tpu_torch.data import native
from selftoktokenizer_tpu_torch.models.vae import VAEConfig
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from selftoktokenizer_tpu_torch.tools import (
    encode_corpus, eval_recon, smoke, tokenize_corpus)
from selftoktokenizer_tpu_torch.train.vae import (
    VAETrainConfig, make_vae_train_state, save_vae_state)
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_tree, mmdit_tables, run_ranks, seeded_inception_sd,
    seeded_lpips_sd, seeded_tree, to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
VQ_MARGIN = 1e-6
METRIC_RTOL = 1e-5
# SSIM's mean on seeded weights is near 0 (about 0.01: a noise reconstruction)
# while its per-pixel terms are of order 1, whose fp32 rounding sets the
# floor: 1e-6 absolute beside the 1e-5 relative
SSIM_ATOL = 1e-6
RFID_RTOL = 1e-3


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    imgs = d / "imgs"
    imgs.mkdir()
    for i, (w, h) in enumerate([(100, 80), (64, 120), (90, 90), (130, 64)] * 2):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img = Image.fromarray(a) if i % 3 else Image.fromarray(a[..., 0])
        img.save(imgs / f"im{i}.{'jpg' if i % 4 == 3 else 'png'}")
    paths = sorted(str(p) for p in imgs.iterdir())
    shard_dir = d / "shards"
    shard_dir.mkdir()
    for s in range(2):
        with tarfile.open(shard_dir / f"shard-{s:04d}.tar", "w") as tf:
            for p in paths[4 * s:4 * s + 4]:
                tf.add(p, arcname=os.path.basename(p))

    cfg = j_load_config(TINY).to_dict()
    jtc = j_tok.tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 41, tables)
    vae_tree = seeded_tree(lambda k: j_vae.vae_init(k, j_vae.VAEConfig(ch=32)), 42)
    tok_pth, vae_pt = d / "tok.pth", d / "vae.pt"
    torch.save({k: torch.from_numpy(np.array(v, np.float32))
                for k, v in j_export.tokenizer_to_state_dict(tree, jtc).items()}, tok_pth)
    torch.save({"first_stage_model." + k: v for k, v in convert.vae_state_dict(vae_tree).items()},
               vae_pt)
    with mock.patch.object(j_pipeline_mod, "VAEConfig", functools.partial(j_vae.VAEConfig, ch=32)):
        jpipe = JaxPipeline(JAttrDict(cfg), ckpt_path=str(tok_pth), vae_path=str(vae_pt),
                            datasize=SIZE, steps=2)
    files = ["--yml-path", TINY, "--pretrained", str(tok_pth), "--vae-path", str(vae_pt),
             "--data_size", str(SIZE), "--device", "cpu"]
    return {"dir": d, "imgs": str(imgs), "paths": paths, "shards": str(shard_dir),
            "cfg": cfg, "jpipe": jpipe, "files": files, "vae_tree": vae_tree,
            "tok_pth": str(tok_pth), "vae_pt": str(vae_pt)}


def _port_pipe(env, **kw):
    return SelftokPipeline(AttrDict(env["cfg"]), ckpt_path=env["tok_pth"],
                           vae_path=env["vae_pt"], datasize=SIZE, device="cpu", **kw)


def _by_path(z):
    """The file's rows in path order. The C++ loader returns each batch of
    consecutive paths in its workers' order, so the rows of one batch stay
    together in path order (no decode fails here)."""
    names = np.asarray([str(p) for p in z["paths"]])
    order = np.argsort(names, kind="stable")
    return names[order], z["tokens"][order], (z["margins"][order] if "margins" in z else None)


def _pixels(env, names):
    """The rows the tool read, by the same C++ decode."""
    out = []
    for n in names:
        if n.startswith("shard-"):
            shard, member = n.split("/", 1)
            with tarfile.open(os.path.join(env["shards"], shard + ".tar")) as tf:
                out.append(native.preprocess_bytes(tf.extractfile(member).read(), SIZE))
        else:
            out.append(native.preprocess_file(n, SIZE))
    return np.concatenate(out)


@pytest.mark.parametrize("source", ["folder", "shards"])
def test_tokenize_corpus_ids_match_jax(env, tmp_path, source):
    out = str(tmp_path / "tok.npz")
    line = tokenize_corpus.main([*env["files"], "--data-dir", env[
        "imgs" if source == "folder" else "shards"], "--out", out, "--batch-size", "4"])
    assert line["loader"] == "native" and line["n"] == 8 and line["out"] == out
    z = np.load(out)
    assert z["tokens"].dtype == np.int32 and z["tokens"].shape == (8, 8)
    if source == "folder":
        names, tokens, _ = _by_path(z)
        assert names.tolist() == env["paths"]
    else:
        # the stream's order, as JAX's TarShardLoader yields it
        tokens, names = z["tokens"], [str(p) for p in z["paths"]]
        assert names == [f"shard-{i // 4:04d}/{os.path.basename(p)}"
                         for i, p in enumerate(env["paths"])]
    pixels = _pixels(env, names)
    # the port's own encode of the same batches: equal
    pipe = _port_pipe(env, encode_only=True)
    np.testing.assert_array_equal(
        np.concatenate([to_np(pipe.encoding(pixels[i:i + 4])) for i in (0, 4)]), tokens)
    # JAX's encoder on the port's latents: equal where the top-2 margin is above 1e-6
    jpipe = env["jpipe"]
    lat = to_np(pipe._images_to_latents(torch.from_numpy(pixels)))
    j_ids, j_marg = (to_np(a) for a in j_enc.encoder_margins(
        jpipe.params["encoder"], jpipe.tcfg.encoder, jnp.asarray(lat)))
    safe = j_marg > VQ_MARGIN
    assert safe.mean() > 0.9
    np.testing.assert_array_equal(tokens[safe], j_ids[safe])
    # JAX's whole encode of the same pixels: its bf16 VAE rounds elsewhere,
    # so ids agree where the JAX margin is above twice the largest shift of
    # the margins between the two sides (and 0.05)
    jw_ids, jw_marg = (to_np(a) for a in jpipe.encoding_margins(pixels))
    t_marg = to_np(pipe.encoding_margins(pixels)[1])
    same = tokens == jw_ids
    thr = max(0.05, 2.0 * float(np.abs(t_marg - jw_marg)[same].max()))
    safe = jw_marg > thr
    assert safe.mean() >= 0.25
    np.testing.assert_array_equal(tokens[safe], jw_ids[safe])


def test_tokenize_corpus_limit_and_margin_stats(env, tmp_path):
    out = str(tmp_path / "lim.npz")
    line = tokenize_corpus.main([*env["files"], "--data-dir", env["imgs"], "--out", out,
                                 "--batch-size", "4", "--limit", "5", "--margin-stats",
                                 "--encode-precision", "default"])
    z = np.load(out)
    names, tokens, margins = _by_path(z)
    assert line["n"] == 5 and names.tolist() == env["paths"][:5]
    assert line["encode_precision"] == "default"
    pipe = _port_pipe(env, encode_only=True, encode_precision="default")
    pixels = _pixels(env, env["paths"][:5])
    ids, marg = zip(*(pipe.encoding_margins(pixels[i:i + 4]) for i in (0, 4)))
    np.testing.assert_array_equal(tokens, np.concatenate([to_np(a) for a in ids]))
    np.testing.assert_array_equal(margins, np.concatenate([to_np(a) for a in marg]))
    st = line["margin_stats"]
    assert st["total_tokens"] == 40 and st["min"] == pytest.approx(float(z["margins"].min()))
    assert st["below_1e-2"] == int((z["margins"] < 1e-2).sum())
    # --limit over shards: the first rows of the stream
    line = tokenize_corpus.main([*env["files"], "--data-dir", env["shards"], "--out",
                                 str(tmp_path / "lim_s.npz"), "--batch-size", "3",
                                 "--limit", "5"])
    keys = [str(p) for p in np.load(tmp_path / "lim_s.npz")["paths"]]
    assert line["n"] == 5 and keys == [f"shard-{i // 4:04d}/{os.path.basename(p)}"
                                       for i, p in enumerate(env["paths"][:5])]


RANK_WORKER = r'''
import sys

import numpy as np
import torch

torch.set_num_threads(1)
from selftoktokenizer_tpu_torch.parallel import distributed as pdist
from selftoktokenizer_tpu_torch.tools import tokenize_corpus

rank, world, init_method = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
files, imgs, shards, out = sys.argv[4].split("|"), sys.argv[5], sys.argv[6], sys.argv[7]
assert pdist.init(backend="gloo", init_method=init_method, rank=rank, world_size=world)
line = tokenize_corpus.main([*files, "--data-dir", imgs, "--out", out + ".npz",
                             "--batch-size", "4"])
assert line["out"] == f"{out}.part{rank}.npz", line
line = tokenize_corpus.main([*files, "--data-dir", shards, "--out", out + "_s.npz",
                             "--batch-size", "4", "--limit", "5"])
assert line["n"] == (3 if rank == 0 else 2), line
print(f"rank {rank} parts written")
'''


def test_two_ranks_write_parts_that_merge_into_the_one_rank_file(env, tmp_path):
    one = str(tmp_path / "one.npz")
    tokenize_corpus.main([*env["files"], "--data-dir", env["imgs"], "--out", one,
                          "--batch-size", "4"])
    base = str(tmp_path / "ranks")
    outs = run_ranks(RANK_WORKER, tmp_path, args=("|".join(env["files"]), env["imgs"],
                                                  env["shards"], base))
    for r, o in enumerate(outs):
        assert f"rank {r} parts written" in o, o
    spec = importlib.util.spec_from_file_location(
        "merge_token_parts", os.path.join(REPO, "tools", "merge_token_parts.py"))
    merge = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(merge)
    merged = str(tmp_path / "merged.npz")
    merge.main(["--glob", base + ".part*.npz", "--out", merged])
    # each rank's batch of four is one of the one-rank run's two batches
    (pa, ta, _), (pb, tb, _) = _by_path(np.load(one)), _by_path(np.load(merged))
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ta, tb)
    s = [np.load(f"{base}_s.part{r}.npz") for r in range(2)]
    assert [str(k) for k in s[0]["paths"]] == [
        f"shard-0000/{os.path.basename(p)}" for p in env["paths"][:3]]
    assert [str(k) for k in s[1]["paths"]] == [
        f"shard-0001/{os.path.basename(p)}" for p in env["paths"][4:6]]


def test_eval_recon_metrics_match_jax(env, tmp_path, monkeypatch):
    fid_pth, lp_pth = tmp_path / "fid.pth", tmp_path / "lpips.pth"
    torch.save(seeded_inception_sd(5), fid_pth)
    torch.save(seeded_lpips_sd(6), lp_pth)
    img_dir = tmp_path / "four"
    img_dir.mkdir()
    for p in env["paths"][:4]:
        os.symlink(p, img_dir / os.path.basename(p))
    # the tool's loop, with a hook that keeps each batch's arrays
    seen = []
    monkeypatch.setattr(eval_recon, "evaluate", functools.partial(
        eval_recon.evaluate,
        on_batch=lambda a, b, n: seen.append((to_np(a), to_np(b), [str(x) for x in n]))))
    res = eval_recon.main([*env["files"], "--data-dir", str(img_dir), "--batch-size", "2",
                           "--steps", "2", "--fid-weights", str(fid_pth),
                           "--lpips-weights", str(lp_pth)])
    assert res["n"] == 4 and res["loader"] == "native" and len(seen) == 2
    ref = np.concatenate([a for a, _, _ in seen])
    rec = np.concatenate([b for _, b, _ in seen])
    names = [n for _, _, ns in seen for n in ns]
    assert sorted(names) == sorted(str(q) for q in img_dir.iterdir())
    assert all(np.isfinite(res[k]) for k in ("psnr", "ssim", "rfid", "lpips"))
    np.testing.assert_array_equal(ref, (_pixels(env, names) + 1.0) / 2.0)
    np.testing.assert_allclose(res["psnr"], float(jnp.mean(j_metrics.psnr(rec, ref))),
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(res["ssim"], float(jnp.mean(j_metrics.ssim(rec, ref))),
                               rtol=METRIC_RTOL, atol=SSIM_ATOL)
    lp_params = j_lp.lpips_from_state_dict(torch.load(lp_pth))
    np.testing.assert_allclose(
        res["lpips"], float(jnp.mean(j_lp.lpips_distance(lp_params, rec, ref))),
        rtol=METRIC_RTOL)
    inc_params = j_inc.inception_from_state_dict(torch.load(fid_pth))
    feats = jax.jit(j_inc.inception_pool3)(inc_params, jnp.asarray(np.concatenate([ref, rec])))
    moments = []
    for f in np.split(np.asarray(feats, np.float64), 2):
        m = j_metrics.StreamingMoments(2048)
        m.update(f)
        moments.append(m.mean_cov())
    want = j_metrics.frechet_distance(*moments[1], *moments[0])
    np.testing.assert_allclose(res["rfid"], want, rtol=RFID_RTOL)


def test_smoke_writes_its_png(env, tmp_path):
    written = smoke.main(["--yml-path", TINY, "--image", env["paths"][1], "--data_size",
                          str(SIZE), "--steps", "2", "--device", "cpu", "--out-dir",
                          str(tmp_path), "--zero-init-std", "0.02"])
    assert written == [str(tmp_path / f"re_0_{SIZE}.png")]
    img = Image.open(written[0])
    assert img.size == (SIZE, SIZE) and img.mode == "RGB"
    assert np.load(tmp_path / "token.npy").shape == (1, 8)


def test_encode_corpus_latents_and_sidecar(env, tmp_path):
    vae = convert.vae_from_jax_tree(env["vae_tree"], VAEConfig(ch=32))
    ckpt = str(tmp_path / "vae_state.pt")
    save_vae_state(ckpt, make_vae_train_state(vae, VAETrainConfig()), vae.cfg)
    out = str(tmp_path / "lat.npy")
    meta = encode_corpus.main(["--vae-ckpt", ckpt, "--images-dir", env["imgs"], "--out", out,
                               "--size", "32", "--batch", "3", "--device", "cpu"])
    arr = np.load(out)
    with open(out + ".meta.json") as f:
        assert json.load(f) == meta
    assert set(meta) == {"shift", "scale", "vae_ckpt", "images_dir", "size", "n",
                         "raw_std", "raw_mean"}
    assert meta["n"] == 8 and meta["size"] == 32 and arr.shape == (8, 4, 4, 16)
    pixels = np.concatenate([native.preprocess_file(p, 32) for p in env["paths"]])
    vb = vae.to(torch.bfloat16)
    raw = np.concatenate([encode_corpus.encode_latents(vb, vae.cfg, pixels[i:i + 3], "cpu")
                          for i in range(0, 8, 3)])
    assert meta["shift"] == float(raw.mean()) and meta["scale"] == float(1.0 / raw.std())
    np.testing.assert_array_equal(arr, ((raw - meta["shift"]) * meta["scale"]).astype(np.float32))
    # the raw latents against JAX's bf16 encode of the same VAE tree and pixels
    # (two of them: XLA's bf16 convolutions are slow on the CPU), within the
    # bf16 tolerance of tests/test_torch_vae.py
    jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jax_tree(env["vae_tree"]))
    want = to_np(jax.jit(lambda p, x: j_vae.vae_encode_mode(p, j_vae.VAEConfig(ch=32), x))(
        jp, jnp.asarray(pixels[:2], jnp.bfloat16)))
    tol = 5e-2 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(raw[:2], want, rtol=5e-2, atol=tol)
