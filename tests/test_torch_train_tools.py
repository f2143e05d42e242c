"""The tokenizer's training driver (``tools/train_tokenizer.py``) and its data
streams (``tools/train_data.py``) on the CPU, in process through ``main``,
on ``tests/data/tiny-eval.yml``:

* the latents file's stream against the reference tool's: the rows of each
  step, over epoch boundaries with ``--data-seed`` and after
  ``--resume-from-steps``, from ``tools/train_tokenizer.py::main`` run under
  ``jax.disable_jit()`` with ``train_step`` replaced by a recorder (the tool
  imports it inside ``main``), against the port's driver with its
  ``train_step`` replaced the same way;
* tar shards: the resumed stream equals the straight one in both skip
  modes, and a resumed run's loss the straight run's; ``--save-per-epochs``;
* the driver: its first step equals a direct ``train_step`` on the same
  batch and generator; 4 steps straight equal 2 + resume 2, with and
  without the EMA copy, and with ``--accum 2``; the metrics file that the
  reference's ``tools/summarize_convergence.py`` reads; the eval records."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import sys
import tarfile
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import selftoktokenizer_tpu.models.tokenizer as j_tok_mod
import selftoktokenizer_tpu.models.vae as j_vae_mod
import selftoktokenizer_tpu.train.trainer as j_trainer
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_, tokenizer_config_from_params
from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig
from selftoktokenizer_tpu_torch.tools import common, train_data, train_tokenizer
from selftoktokenizer_tpu_torch.train import trainer
from tests.torch_port_helpers import TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


def _root(name):
    spec = importlib.util.spec_from_file_location(
        "root_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _zero_logs():
    return {"loss": 0.0, "dm_mse": 0.0, "vq_perplexity": 0.0}


def jax_tool_rows(argv, resume=0):
    """The batches the reference tool hands to train_step, step by step."""
    tool = _root("train_tokenizer")
    rows = []

    def record(state, opt, tcfg, tc, batch, rng):
        rows.append(np.asarray(batch))
        return state, {k: jnp.float32(v) for k, v in _zero_logs().items()}

    def restore(path, like, exclude_opt=False):
        return dataclasses.replace(like, step=jnp.asarray(resume, jnp.int32))

    # the stream needs no weights: an empty state, no model or VAE init
    empty = j_trainer.TokenizerTrainState(params={}, opt_state=None, vq_state=None,
                                          ema_params=None, step=jnp.zeros((), jnp.int32))
    with mock.patch.object(j_trainer, "train_step", record), \
            mock.patch.object(j_trainer, "restore_train_state", restore), \
            mock.patch.object(j_trainer, "make_train_state", lambda *a: (empty, None)), \
            mock.patch.object(j_tok_mod, "tokenizer_init", lambda key, tcfg: None), \
            mock.patch.object(j_vae_mod, "vae_init", lambda key, cfg: None), \
            mock.patch.object(sys, "argv", ["train_tokenizer.py"] + argv), \
            contextlib.redirect_stdout(io.StringIO()), jax.disable_jit():
        tool.main()
    return rows


def port_rows(argv, resume=0):
    """The batches the port's driver hands to train_step."""
    rows = []

    def record(state, tcfg, tc, batch, rng=None, **kw):
        rows.append(batch.numpy().copy())
        state.step += 1
        return state, {k: torch.tensor(v) for k, v in _zero_logs().items()}

    def restore(path, like, exclude_opt=False):
        like.step = resume
        return like

    with mock.patch.object(trainer, "train_step", record), \
            mock.patch.object(trainer, "restore_train_state", restore), \
            contextlib.redirect_stdout(io.StringIO()):
        train_tokenizer.main(argv + ["--device", "cpu"])
    return rows


@pytest.fixture(scope="module")
def lat_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("lat")
    path = d / "lat.npy"
    np.save(path, np.random.default_rng(0).standard_normal((30, 8, 8, 16)).astype(np.float32))
    return str(path)


@pytest.mark.parametrize("data_seed", [None, 3])
def test_latents_stream_rows_equal_the_reference_tool(lat_file, tmp_path, data_seed):
    """Batch 8 (the JAX mesh's 8 CPU devices) over 30 rows: 3 batches a pass,
    7 steps cross two epoch ends; resumed at step 4."""
    argv = ["--yml-path", TINY, "--data_size", str(SIZE), "--batch-size", "8",
            "--latents-file", lat_file, "--log-interval", "100", "--ckpt-interval", "1000",
            "--ckpt-dir", str(tmp_path / "ck")]
    if data_seed is not None:
        argv += ["--data-seed", str(data_seed)]
    want = jax_tool_rows(argv + ["--steps", "7"])
    got = port_rows(argv + ["--steps", "7"])
    assert len(want) == len(got) == 7
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    want_r = jax_tool_rows(argv + ["--steps", "7", "--resume-from-steps", "4"], resume=4)
    got_r = port_rows(argv + ["--steps", "7", "--resume-from-steps", "4"], resume=4)
    assert len(want_r) == len(got_r) == 3
    for w, g, s in zip(want_r, got_r, got[4:]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)
    if data_seed is not None:
        # each pass its own permutation: epoch 2's first batch is no repeat
        assert not np.array_equal(got[3], got[0])


def test_stream_epoch_flags_and_held_out_rows():
    lat = np.arange(10 * 2).reshape(10, 2, 1, 1).astype(np.float32)
    passes = train_data.Passes()
    it = train_data.with_epoch_flags(train_data.latents_stream(lat, 7, 3, 5, passes), passes)
    got = [next(it) for _ in range(5)]
    # 2 batches a pass: the 2nd and 4th complete epochs 1 and 2
    assert [f for _, f in got] == [None, 1, None, 2, None]
    order = np.random.default_rng((5, 0)).permutation(7)
    np.testing.assert_array_equal(got[0][0], lat[np.sort(order[:3])])
    assert all(b.max() < 14 for b, _ in got)      # rows 7-9 are held out


# ---------------------------------------------------------------------------
# tar shards
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_env(tmp_path_factory):
    """Two shards of 8 PNGs each, and a narrow VAE (.pt, ch 32)."""
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(1)
    imgs = d / "imgs"
    imgs.mkdir()
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (80, 72, 3), dtype=np.uint8)).save(imgs / f"{i}.png")
    data = d / "data"
    data.mkdir()
    for s in ("shard-000.tar", "shard-001.tar"):
        with tarfile.open(data / s, "w") as tf:
            for f in sorted(os.listdir(imgs)):
                tf.add(imgs / f, arcname=f)
    vae = SDVAE(VAEConfig(ch=32))
    init_weights_(vae, common.generator("cpu", 5), 0.02)
    torch.save(vae.state_dict(), d / "vae.pt")
    return str(data), str(d / "vae.pt"), str(imgs)


def _tar_argv(shard_env, tmp_path, extra):
    data, vae, _ = shard_env
    return ["--yml-path", TINY, "--data_size", str(SIZE), "--batch-size", "4",
            "--data-dir", data, "--vae-path", vae, "--data-seed", "7", "--shuffle-buffer", "4",
            "--log-interval", "1", "--ckpt-dir", str(tmp_path)] + extra


@pytest.mark.parametrize("exact", [False, True], ids=["raw-member-skip", "exact-skip"])
def test_tar_stream_resumes_where_the_straight_one_was(shard_env, tmp_path, exact):
    """16 members in batches of 4: 4 batches an epoch; 6 steps cross one
    epoch end; the resume skip of 5 batches crosses it too."""
    extra = ["--resume-skip-exact"] if exact else []
    straight = port_rows(_tar_argv(shard_env, tmp_path, extra + ["--steps", "6"]))
    resumed = port_rows(_tar_argv(shard_env, tmp_path, extra + ["--steps", "6",
                                                                "--resume-from-steps", "5"]),
                        resume=5)
    assert len(straight) == 6 and len(resumed) == 1
    np.testing.assert_array_equal(resumed[0], straight[5])
    # epoch 2 reshuffles the shards and the buffer
    assert not np.array_equal(straight[4], straight[0])


def test_tar_training_resumed_equals_straight(shard_env, tmp_path):
    out = {}
    for name, extra in (("a", ["--steps", "3", "--ckpt-interval", "10"]),
                        ("b", ["--steps", "1", "--ckpt-interval", "1"]),
                        ("b2", ["--steps", "3", "--ckpt-interval", "10",
                                "--resume-from-steps", "1"])):
        ck = tmp_path / ("a" if name == "a" else "b")
        with contextlib.redirect_stdout(io.StringIO()):
            out[name] = train_tokenizer.main(_tar_argv(shard_env, ck, extra + ["--device", "cpu"]))
    assert out["a"]["final_loss"] == out["b2"]["final_loss"]
    a, b = out["a"]["state"].model.state_dict(), out["b2"]["state"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_save_per_epochs_checkpoints_each_epoch_end(shard_env, tmp_path):
    """--save-per-epochs 1 with 4 batches an epoch: checkpoints at the end of
    epochs 1 and 2 (steps 4 and 8), learned through the one-batch look-ahead."""
    rows = port_rows(_tar_argv(shard_env, tmp_path, ["--steps", "9", "--save-per-epochs", "1",
                                                     "--ckpt-interval", "0"]))
    assert len(rows) == 9
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_8"]


def test_a_folder_without_a_full_batch_raises(shard_env, tmp_path):
    _, vae, imgs = shard_env
    with pytest.raises(RuntimeError, match="no full batch of 16"):
        port_rows(["--yml-path", TINY, "--data_size", str(SIZE), "--batch-size", "16",
                   "--data-dir", imgs, "--vae-path", vae, "--steps", "1",
                   "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def _run(argv):
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        res = train_tokenizer.main(argv + ["--device", "cpu"])
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line == {"final_loss": res["final_loss"], "steps": res["steps"]}
    return res


def _lat_argv(lat_file, ck, extra):
    return ["--yml-path", TINY, "--data_size", str(SIZE), "--batch-size", "4",
            "--latents-file", lat_file, "--data-seed", "2", "--log-interval", "1",
            "--ckpt-dir", str(ck)] + extra


def test_first_step_equals_a_direct_train_step(tmp_path):
    res = _run(["--yml-path", TINY, "--data_size", str(SIZE), "--batch-size", "4", "--synthetic",
                "--steps", "1", "--log-interval", "1", "--ckpt-interval", "0",
                "--ckpt-dir", str(tmp_path)])
    tcfg = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    cpu = torch.device("cpu")
    state = trainer.make_train_state(train_tokenizer.build_tokenizer(tcfg, 123, cpu), tcfg,
                                     trainer.TrainConfig(max_steps=1))
    batch = torch.from_numpy(next(train_data.synthetic_stream(4, SIZE // 8)))
    state, logs = trainer.train_step(
        state, tcfg, trainer.TrainConfig(max_steps=1), batch,
        rng=common.generator(cpu, 123, train_tokenizer.STEP_STREAM, 0))
    assert res["final_loss"] == float(logs["loss"])
    got = res["state"].model.state_dict()
    assert all(torch.equal(v, got[k]) for k, v in state.model.state_dict().items())
    assert torch.equal(res["state"].vq_state.embed, state.vq_state.embed)


@pytest.mark.parametrize("extra", [[], ["--ema-decay", "0.9"], ["--accum", "2"]],
                         ids=["plain", "ema", "accum"])
def test_straight_equals_resumed(lat_file, tmp_path, extra):
    straight = _run(_lat_argv(lat_file, tmp_path / "a", extra + ["--steps", "4",
                                                                 "--ckpt-interval", "0"]))
    _run(_lat_argv(lat_file, tmp_path / "b", extra + ["--steps", "2", "--ckpt-interval", "2"]))
    resumed = _run(_lat_argv(lat_file, tmp_path / "b", extra + [
        "--steps", "4", "--ckpt-interval", "4", "--resume-from-steps", "2"]))
    assert straight["final_loss"] == resumed["final_loss"]
    a, b = straight["state"], resumed["state"]
    assert b.step == 4 and os.path.exists(tmp_path / "b" / "step_4")
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for f, v in a.vq_state.asdict().items():
        assert torch.equal(v, getattr(b.vq_state, f)), f
    if a.ema_params is not None:
        assert all(torch.equal(v, b.ema_params[k]) for k, v in a.ema_params.items())
    # the file's step must be the one asked for
    shutil.copy(tmp_path / "b" / "step_4", tmp_path / "b" / "step_3")
    with pytest.raises(AssertionError, match="is at step 4"):
        _run(_lat_argv(lat_file, tmp_path / "b", extra + ["--steps", "5",
                                                         "--resume-from-steps", "3"]))


def test_accum_step_equals_train_step_accum(lat_file, tmp_path):
    res = _run(_lat_argv(lat_file, tmp_path, ["--steps", "1", "--accum", "2",
                                              "--ckpt-interval", "0"]))
    tcfg = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params))
    cpu = torch.device("cpu")
    tc = trainer.TrainConfig(max_steps=1)
    state = trainer.make_train_state(train_tokenizer.build_tokenizer(tcfg, 123, cpu), tcfg, tc)
    passes = train_data.Passes()
    batch = torch.from_numpy(next(train_data.latents_stream(np.load(lat_file), 30, 4, 2, passes)))
    state, logs = trainer.train_step_accum(
        state, tcfg, tc, batch, 2, rng=common.generator(cpu, 123, train_tokenizer.STEP_STREAM, 0))
    assert res["final_loss"] == float(logs["loss"])
    got = res["state"].model.state_dict()
    assert all(torch.equal(v, got[k]) for k, v in state.model.state_dict().items())


def test_metrics_file_reads_through_summarize_convergence(lat_file, tmp_path):
    metrics = tmp_path / "m.jsonl"
    _run(_lat_argv(lat_file, tmp_path, [
        "--steps", "4", "--ckpt-interval", "0", "--ema-decay", "0.9", "--eval-interval", "2",
        "--eval-steps", "2", "--eval-batch", "4", "--metrics-out", str(metrics),
        "--recon-interval", "4"]))
    recs = [json.loads(s) for s in open(metrics)]
    train = [r for r in recs if "loss_avg" in r]
    evals = [r for r in recs if "eval_latent_mse" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert [r["step"] for r in evals] == [0, 2, 4]
    for r in train:
        assert {"loss_avg", "dm_mse", "vq_perplexity", "vq_commit_loss", "steps_per_s",
                "epoch", "grad_norm"} <= set(r)
    for r in evals:
        assert {"eval_latent_mse", "eval_latent_snr_db", "eval_latent_mse_ema",
                "eval_latent_snr_db_ema"} <= set(r)
        assert all(np.isfinite(v) for v in r.values())
    assert os.path.exists(tmp_path / "recon_4.png")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        _root("summarize_convergence").main(str(metrics))
    out = buf.getvalue()
    assert "steps logged: 4 (to 4), all finite: True" in out
    assert "eval latent mse:" in out


def test_flags_with_nothing_to_do_and_the_missing_gpu(lat_file, tmp_path):
    args = train_tokenizer.build_parser().parse_args(["--donate-state"])
    assert args.donate_state and not hasattr(args, "pretrained")
    with pytest.raises(SystemExit):
        train_tokenizer.build_parser().parse_args(["--pretrained", "x.pth"])
    with pytest.raises(ValueError, match="fsdp=2 .* world size 1"):
        _run(_lat_argv(lat_file, tmp_path, ["--steps", "1", "--mesh-fsdp", "2"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train_tokenizer.main(_lat_argv(lat_file, tmp_path, ["--steps", "1"]))
