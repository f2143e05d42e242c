"""The VAE and renderer training drivers, tier certification and the
end-to-end demo of the port (``tools/train_vae.py``, ``train_renderer.py``,
``certify_tiers.py``, ``demo_e2e.py``) on the CPU, in process through
``main`` at tiny widths:

* ``train_vae`` (``--ch 32 --ch-mult 1,2``): the loss falls, the held-out
  split and each batch's rows follow the reference tool's numpy formula,
  two runs agree, and the checkpoint loads through ``load_vae_params`` and
  feeds ``encode_corpus``;
* ``train_renderer`` from a ``.pth`` of the JAX exporter and from a train
  state of the port's tokenizer driver: the frozen encoder, the checkpoint
  (with the VQ state carried on from a train state), its export loading
  strictly into the port's pipeline, its first step equal across runs;
* ``certify_tiers``: the records of the reference tool (run in process on
  the same seeded weights, its checkpoint read replaced by the tree) against
  the port's, the decode fed JAX's noise;
* ``demo_e2e``: the grid's shape, the JSON keys, PSNR / SSIM recomputed
  through ``utils/metrics.py``;
* with no GPU each driver raises unless it is given ``--device cpu``."""

import contextlib
import importlib.util
import io
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

import selftoktokenizer_tpu.core.checkpoint as j_ckpt
from selftoktokenizer_tpu.core import export as j_export
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import encoder as j_enc
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.pipeline.preprocess import load_image as j_load_image
from selftoktokenizer_tpu_torch.core import checkpoint as ckpt
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import AttrDict
from selftoktokenizer_tpu_torch.models.tokenizer import (
    ImageTokenizer, init_weights_, tokenizer_config_from_params)
from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from selftoktokenizer_tpu_torch.tools import (
    certify_tiers, common, convert_ckpt, demo_e2e, encode_corpus, train_renderer,
    train_tokenizer, train_vae)
from selftoktokenizer_tpu_torch.train import vae as vt
from selftoktokenizer_tpu_torch.train.vae import (
    VAETrainConfig, load_vae_params, make_vae_train_state, save_vae_state)
from selftoktokenizer_tpu_torch.utils import metrics
from tests.torch_port_helpers import TINY, encoder_tables, mmdit_tables, seeded_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        out = fn(*a)
    return out, buf.getvalue()


def _cfg_dict(renderer=False):
    cfg = j_load_config(TINY).to_dict()
    if renderer:
        cfg["tokenizer"]["params"]["model"] = "MMDiT_XL_Renderer"
    return cfg


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A corpus of 16 PNGs (64 px after preprocessing), a narrow VAE's
    checkpoint (ch 32, SD3's 8x downsampling), its latents and sidecar
    (encode_corpus), the renderer yml, a seeded JAX tokenizer tree with its
    VQ state and EMA tree, and the port's train state file of those
    weights."""
    d = tmp_path_factory.mktemp("drivers")
    rng = np.random.default_rng(3)
    imgs = d / "imgs"
    imgs.mkdir()
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (72, 80, 3), dtype=np.uint8)).save(
            imgs / f"im{i:02d}.png")
    vae = SDVAE(VAEConfig(ch=32))
    init_weights_(vae, common.generator("cpu", 9), 0.02)
    save_vae_state(d / "vae", make_vae_train_state(vae, VAETrainConfig()), vae.cfg)
    _quiet(encode_corpus.main, ["--vae-ckpt", str(d / "vae"), "--images-dir", str(imgs),
                                "--out", str(d / "lat.npy"), "--size", "64", "--batch", "8"]
           + CPU)
    (d / "ren.yml").write_text(yaml.safe_dump(_cfg_dict(renderer=True)))

    cfg = _cfg_dict()
    jtc = j_tok.tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 71, tables)
    ema_tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 72, tables)
    vq = j_vq.vq_state_init(tree["encoder"]["quantizer"], jtc.k)._replace(
        initted=np.bool_(True), steps=np.int32(4))
    tcfg = tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tok = convert.tokenizer_from_jax_tree(tree, tcfg)
    ema = {k: v.detach() for k, v in
           convert.tokenizer_from_jax_tree(ema_tree, tcfg).named_parameters()}
    ckpt.save_checkpoint(d / "step_4", {
        "params": tok.state_dict(), "ema_params": ema,
        "vq_state": convert.vq_state_from_jax(vq).asdict(), "step": 4})
    return {"dir": d, "imgs": str(imgs), "vae": str(d / "vae"), "lat": str(d / "lat.npy"),
            "ren_yml": str(d / "ren.yml"), "jtc": jtc, "tcfg": tcfg, "tree": tree,
            "ema_tree": ema_tree, "vq": vq, "tok_ckpt": str(d / "step_4")}


# ---------------------------------------------------------------------------
# train_vae
# ---------------------------------------------------------------------------

def _vae_argv(env, ck, steps):
    return ["--data-dir", env["imgs"], "--size", "32", "--steps", str(steps), "--batch-size", "8",
            "--lr", "2e-3", "--warmup", "0", "--ch", "32", "--ch-mult", "1,2", "--holdout", "4",
            "--eval-batch", "2", "--seed", "3", "--log-interval", "1", "--eval-interval", "4",
            "--ckpt-interval", "4", "--ckpt-dir", str(ck), "--metrics-out", str(ck) + ".jsonl",
            "--sample-out", str(ck) + ".png"] + CPU


def test_train_vae_split_batches_loss_and_checkpoint(env, tmp_path):
    batches, evals = [], []
    step, ev = vt.vae_train_step, vt.vae_eval_psnr

    def rec_step(state, cfg, tc, batch, **kw):
        batches.append(batch.numpy().copy())
        return step(state, cfg, tc, batch, **kw)

    def rec_eval(vae, cfg, x):
        evals.append(x.numpy().copy())
        return ev(vae, cfg, x)

    with mock.patch.object(vt, "vae_train_step", rec_step), \
            mock.patch.object(vt, "vae_eval_psnr", rec_eval):
        res, out = _quiet(train_vae.main, _vae_argv(env, tmp_path / "a", 6))
    line = json.loads(out.strip().splitlines()[-1])
    assert line["steps"] == 6 and line["n_params"] == res["n_params"]
    assert {"eval_psnr_db", "eval_ssim", "step"} <= set(line)

    # the reference tool's formula: sorted paths, the last --holdout held out,
    # uint8 rows, default_rng(seed) permuting the training rows each pass
    paths = sorted(os.path.join(env["imgs"], f) for f in os.listdir(env["imgs"]))
    u8 = np.stack([((j_load_image(q, 32)[0] + 1) * 127.5).round().clip(0, 255).astype(np.uint8)
                   for q in paths])
    n_train = len(paths) - 4
    rng = np.random.default_rng(3)
    want = []
    while len(want) < 6:
        order = rng.permutation(n_train)
        want += [np.sort(order[i:i + 8]) for i in range(0, n_train - 8 + 1, 8)]
    for b, idx in zip(batches, want):
        np.testing.assert_array_equal(b, u8[idx].astype(np.float32) / 127.5 - 1.0)
    assert len(evals) == 3         # steps 0, 4 and the last
    for x in evals:
        np.testing.assert_array_equal(x, u8[n_train:n_train + 2].astype(np.float32) / 127.5 - 1.0)

    losses = [json.loads(s)["loss"] for s in open(str(tmp_path / "a") + ".jsonl")
              if "loss" in s]
    assert len(losses) == 6 and np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < losses[0], losses
    # the GT row over the recon row, --eval-batch images wide
    assert Image.open(str(tmp_path / "a") + ".png").size == (2 * 32, 2 * 32)

    # the checkpoint: loads, feeds encode_corpus, and a second run equals it
    vae, cfg = load_vae_params(tmp_path / "a" / "step_6")
    assert cfg.ch_mult == (1, 2) and cfg.ch == 32
    meta, _ = _quiet(encode_corpus.main, ["--vae-ckpt", str(tmp_path / "a" / "step_6"),
                                          "--images-dir", env["imgs"], "--out",
                                          str(tmp_path / "lat.npy"), "--size", "32"] + CPU)
    lat = np.load(tmp_path / "lat.npy")
    assert lat.shape == (16, 16, 16, 16) and np.isfinite(lat).all() and meta["n"] == 16
    _quiet(train_vae.main, _vae_argv(env, tmp_path / "b", 6))
    b, _ = load_vae_params(tmp_path / "b" / "step_6")
    sa, sb = vae.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_train_vae_refuses_a_width_groupnorm_cannot_split(env, tmp_path):
    argv = _vae_argv(env, tmp_path, 1)
    argv[argv.index("--ch") + 1] = "48"
    with pytest.raises(AssertionError, match="multiple of 32"):
        _quiet(train_vae.main, argv)


# ---------------------------------------------------------------------------
# train_renderer
# ---------------------------------------------------------------------------

def _ren_argv(env, src, ck, steps, extra=()):
    return ["--yml-path", env["ren_yml"], "--tokenizer-ckpt", src, "--latents-file", env["lat"],
            "--steps", str(steps), "--batch-size", "4", "--log-interval", "1",
            "--ckpt-interval", str(steps), "--ckpt-dir", str(ck),
            "--metrics-out", str(ck) + ".jsonl"] + list(extra) + CPU


def _renderer_export_loads(env, ck, tmp_path, ema=False):
    """convert_ckpt export of a renderer checkpoint loads strictly into the
    port's pipeline of the renderer config; returns the exported dict."""
    dst = str(tmp_path / ("ren_ema.pth" if ema else "ren.pth"))
    sd, _ = _quiet(convert_ckpt.main, ["export", "--yml-path", env["ren_yml"], "--src", ck,
                                       "--dst", dst] + (["--ema"] if ema else []))
    pipe = SelftokPipeline(AttrDict(_cfg_dict(renderer=True)), ckpt_path=dst, datasize=64,
                           device="cpu")
    own = {**{"encoder." + k: v for k, v in pipe.encoder.state_dict().items()},
           **{"model." + k: v for k, v in pipe.model.state_dict().items()}}
    for k, v in own.items():
        assert torch.equal(v, sd[k]), k
    return sd


def test_train_renderer_from_a_jax_exported_pth(env, tmp_path):
    jtc, tree, vq = env["jtc"], env["tree"], env["vq"]
    pth = tmp_path / "tok.pth"
    torch.save({k: torch.from_numpy(np.array(v, np.float32)) for k, v in
                j_export.tokenizer_to_state_dict(tree, jtc, vq_state=vq).items()}, pth)
    res, out = _quiet(train_renderer.main, _ren_argv(
        env, str(pth), tmp_path / "a", 3, ["--ema-decay", "0.9", "--eval-interval", "3",
                                           "--eval-batch", "4", "--eval-image-space"]))
    assert json.loads(out.strip().splitlines()[-1]) == {
        "final_recon_mse": res["final_recon_mse"], "steps": 3}
    want = convert.encoder_state_dict(tree["encoder"], env["tcfg"].encoder)
    for k, v in res["encoder"].state_dict().items():
        assert torch.equal(v, want[k]), k
    raw = ckpt.restore_checkpoint(tmp_path / "a" / "step_3")
    assert "vq_state" not in raw and raw["step"] == 3
    rcfg = tokenizer_config_from_params(_cfg_dict(renderer=True)["tokenizer"]["params"])
    with torch.device("meta"):
        assert set(raw["params"]) == set(ImageTokenizer(rcfg).state_dict())
    assert set(raw["ema_params"]) <= set(raw["params"])
    recs = [json.loads(s) for s in open(str(tmp_path / "a") + ".jsonl")]
    assert [r["step"] for r in recs] == [0, 1, 2, 3, 3]
    assert {"eval_recon_mse", "eval_recon_mse_ema", "eval_image_psnr_db",
            "eval_image_ssim_ema"} <= set(recs[-1])
    assert os.path.exists(tmp_path / "a" / "imgrecon_3.png")
    _renderer_export_loads(env, str(tmp_path / "a" / "step_3"), tmp_path)
    _renderer_export_loads(env, str(tmp_path / "a" / "step_3"), tmp_path, ema=True)
    # the first step of a 1-step run is the 3-step run's first
    one, _ = _quiet(train_renderer.main, _ren_argv(env, str(pth), tmp_path / "b", 1, [
        "--eval-interval", "3", "--eval-batch", "4"]))
    assert one["final_recon_mse"] == recs[1]["recon_mse"]


def test_train_renderer_from_a_port_train_state(env, tmp_path):
    tok_res, _ = _quiet(train_tokenizer.main, [
        "--yml-path", TINY, "--data_size", "64", "--batch-size", "4", "--latents-file",
        env["lat"], "--steps", "2", "--log-interval", "1", "--ckpt-interval", "2",
        "--ckpt-dir", str(tmp_path / "tok")] + CPU)
    src = str(tmp_path / "tok" / "step_2")
    res, _ = _quiet(train_renderer.main, _ren_argv(env, src, tmp_path / "ren", 2))
    enc = tok_res["state"].model.encoder.state_dict()
    assert all(torch.equal(v, enc[k]) for k, v in res["encoder"].state_dict().items())
    raw = ckpt.restore_checkpoint(tmp_path / "ren" / "step_2")
    for f, v in tok_res["state"].vq_state.asdict().items():
        assert torch.equal(raw["vq_state"][f], v), f
    sd = _renderer_export_loads(env, str(tmp_path / "ren" / "step_2"), tmp_path)
    # the VQ buffers make it a whole reference state dict
    assert "encoder.quantizer._codebook.cluster_size" in sd and "encoder.quantizer.count" in sd


# ---------------------------------------------------------------------------
# certify_tiers
# ---------------------------------------------------------------------------

TIER_RTOL = 1e-4
# 'default' is a bf16 trunk on both sides, rounded at other places by XLA and
# PyTorch: ids may differ only where the 'highest' top-2 margin is below the
# bf16 rule of tests/test_torch_pipeline.py, and margins move by bf16 noise
DEFAULT_TIER_MARGIN = 0.05
DEFAULT_TIER_ATOL = 5e-3


def _jax_certify(env, lat_path, out, ema):
    tool_spec = importlib.util.spec_from_file_location(
        "root_certify_tiers", os.path.join(REPO, "tools", "certify_tiers.py"))
    tool = importlib.util.module_from_spec(tool_spec)
    tool_spec.loader.exec_module(tool)
    raw = {"params": env["tree"], "ema_params": env["ema_tree"], "step": 4}
    argv = ["certify_tiers.py", "--ckpt", env["tok_ckpt"], "--yml-path", TINY,
            "--latents-file", lat_path, "--n", "32", "--batch", "16", "--eval-batch", "8",
            "--decode-steps", "2", "--out", out] + (["--ema"] if ema else [])
    with mock.patch.object(j_ckpt, "restore_checkpoint", lambda path: raw), \
            mock.patch.object(sys, "argv", argv):
        tool.main()
    return [json.loads(s) for s in open(out)]


@pytest.mark.parametrize("ema", [False, True], ids=["raw", "ema"])
def test_certify_tiers_records_equal_the_reference_tool(env, tmp_path, ema):
    """The sizes of the reference's own test: 48 rows of 8 x 8 latents, 32
    statistics rows in batches of 16, 8 held-out rows, a 2-step decode.
    'highest' and 'high' (the same fp32 trunk on the CPU) equal the
    reference's records; 'default' is held id by id."""
    lat_path = str(tmp_path / "lat.npy")
    lat = np.random.default_rng(0).standard_normal((48, 8, 8, 16)).astype(np.float32)
    np.save(lat_path, lat)
    want = _jax_certify(env, lat_path, str(tmp_path / "jax.jsonl"), ema)
    tcfg = env["tcfg"]
    tok, raw = certify_tiers.load_tokenizer(env["tok_ckpt"], tcfg, ema, "cpu")
    noise = np.array(jax.random.normal(jax.random.PRNGKey(certify_tiers.DECODE_NOISE),
                                       (8, 8, 8, 16)))
    meta = {"ckpt": env["tok_ckpt"], "step": 4, "ema": ema}
    got, _ = _quiet(certify_tiers.certify, tok, tcfg, lat, 32, 16, 8, 2, "cpu",
                    torch.from_numpy(noise), meta)
    assert [r["tier"] for r in got] == [r["tier"] for r in want] == ["highest", "high", "default"]
    # 'default', id by id: the port's ids against the reference's bf16 trunk
    params = env["ema_tree"] if ema else env["tree"]
    enc = jax.tree_util.tree_map(jnp.asarray, params["encoder"])
    x = lat[:32]
    j_ids, _ = j_enc.encoder_margins(enc, env["jtc"].encoder, jnp.asarray(x),
                                     trunk_dtype=jnp.bfloat16, fast_attn=True)
    j_marg = np.asarray(j_enc.encoder_margins(enc, env["jtc"].encoder, jnp.asarray(x))[1])
    t_ids, _ = certify_tiers.tier_ids(tok, tcfg, torch.from_numpy(x), "default")
    safe = j_marg > DEFAULT_TIER_MARGIN
    assert safe.mean() > 0.25
    np.testing.assert_array_equal(t_ids[safe], np.asarray(j_ids)[safe])
    for w, g in zip(want, got):
        if w["tier"] == "default":
            assert {k for k in g if not k.startswith("flip_")} == \
                {k for k in w if not k.startswith("flip_")}
            for k in ("margin_median", "margin_p1"):
                np.testing.assert_allclose(g[k], w[k], atol=DEFAULT_TIER_ATOL, err_msg=k)
            # the share below 1e-2 may differ by the tokens whose margin lies
            # within the bf16 noise of 1e-2
            near = np.mean(np.abs(j_marg - 1e-2) < DEFAULT_TIER_ATOL)
            assert abs(g["frac_margin_lt_1e2"] - w["frac_margin_lt_1e2"]) <= near
            continue
        assert set(g) == set(w), (w["tier"], set(g) ^ set(w))
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=TIER_RTOL, atol=1e-6, err_msg=k)
            else:
                assert g[k] == v, k
    # the file the tool writes: the same records as the function's
    out, _ = _quiet(certify_tiers.main, ["--ckpt", env["tok_ckpt"], "--yml-path", TINY,
                                         "--latents-file", lat_path, "--n", "32", "--batch", "16",
                                         "--eval-batch", "8", "--decode-steps", "2",
                                         "--out", str(tmp_path / "port.jsonl")]
                    + (["--ema"] if ema else []) + CPU)
    assert [json.loads(s) for s in open(tmp_path / "port.jsonl")] == out
    assert [{k: v for k, v in r.items() if k != "decode_mse"} for r in out] == \
        [{k: v for k, v in r.items() if k != "decode_mse"} for r in got]


# ---------------------------------------------------------------------------
# demo_e2e
# ---------------------------------------------------------------------------

def test_demo_e2e_grid_and_scores(env, tmp_path):
    rcfg = tokenizer_config_from_params(_cfg_dict(renderer=True)["tokenizer"]["params"])
    ren = ImageTokenizer(rcfg)
    init_weights_(ren, common.generator("cpu", 13), 0.02)
    ckpt.save_checkpoint(tmp_path / "ren", {"params": ren.state_dict(), "step": 1})
    argv = ["--tokenizer-ckpt", env["tok_ckpt"], "--renderer-ckpt", str(tmp_path / "ren"),
            "--yml-path", TINY, "--renderer-yml", env["ren_yml"], "--latents-file", env["lat"],
            "--n", "3", "--decode-steps", "2", "--out", str(tmp_path / "demo.png"),
            "--json-out", str(tmp_path / "demo.jsonl")] + CPU
    (res, rows), _ = _quiet(demo_e2e.run, demo_e2e.build_parser().parse_args(argv))
    assert list(rows) == res["grid_rows"] == ["gt", "vae", "diffusion", "renderer"]
    assert set(res) == {"n", "ema", "tokens_per_image", "grid", "grid_rows"} | {
        f"{r}_{m}" for r in ("vae", "diffusion", "renderer") for m in ("psnr_db", "ssim")}
    assert res["tokens_per_image"] == 8 and res["n"] == 3
    assert Image.open(tmp_path / "demo.png").size == (3 * 64, 4 * 64)
    assert json.loads(open(tmp_path / "demo.jsonl").read()) == res
    a = (rows["gt"] + 1) / 2
    for r in ("vae", "diffusion", "renderer"):
        b = (rows[r] + 1) / 2
        assert res[f"{r}_psnr_db"] == round(float(torch.mean(metrics.psnr(a, b))), 2)
        assert res[f"{r}_ssim"] == round(float(torch.mean(metrics.ssim(a, b))), 4)
    # the ground truth is the corpus's last 3 images
    paths = sorted(os.listdir(env["imgs"]))[-3:]
    want = np.concatenate([j_load_image(os.path.join(env["imgs"], p), 64) for p in paths])
    np.testing.assert_array_equal(rows["gt"].numpy(), want)


# ---------------------------------------------------------------------------
# no GPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    (train_tokenizer, ["--synthetic"]),
    (train_vae, ["--data-dir", "x"]),
    (train_renderer, ["--tokenizer-ckpt", "x", "--latents-file", "x"]),
    (certify_tiers, ["--ckpt", "x", "--yml-path", TINY, "--latents-file", "x"]),
    (demo_e2e, ["--tokenizer-ckpt", "x", "--latents-file", "x"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1] or None)
def test_each_driver_raises_without_a_gpu_unless_asked_for_the_cpu(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main(argv)
