"""The port's measurement tools (``selftoktokenizer_tpu_torch/tools/bench_*``
and ``measure_k1024``) on the CPU: each ``main(argv)`` at a tiny size
(``tests/data/tiny-eval.yml``, ``--device cpu``, the pipelines' VAE
narrowed to ch=32 so the runs stay short) prints one JSON line with its
documented keys. The values the tools compute are held against the JAX
package: ``bench_int8``'s PSNR against ``utils/metrics.py::psnr``,
``bench_train``'s changed config and FLOP count against the JAX config
changed the same way and ``utils/flops.py``; ``bench_render_overlap``'s
three loops give equal images batch for batch, and the fused loop's
latents equal JAX's ``decoding_with_renderer`` on the same carried
weights within 3e-2 of their scale in bf16 (tests/test_torch_renderer.py's
bound), its images by the bf16 image rule of tests/torch_port_helpers.py;
``bench_scaling`` on two gloo ranks: the ids gathered over the ranks equal
a one-rank encode of the same images under the 1e-6 top-2 margin rule.
tests/test_torch_bench_tools_jax.py holds the rematerialised train step
and the K=1024 ids against JAX."""

import dataclasses
import functools
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.utils import flops as j_flops
from selftoktokenizer_tpu.utils import metrics as j_metrics
import selftoktokenizer_tpu_torch.pipeline.pipeline as t_pipeline_mod
from selftoktokenizer_tpu_torch.core.config import load_config
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from selftoktokenizer_tpu_torch.models.vae import VAEConfig
from selftoktokenizer_tpu_torch.tools import (
    bench_decode512, bench_encode_serving, bench_encoder_bisect, bench_flash, bench_int8,
    bench_loader, bench_render_overlap, bench_scaling, bench_train, common, measure_k1024)
from tests.torch_port_helpers import (
    TINY, assert_images_close, jax_render, pipeline_pair, run_ranks, to_np)

VQ_MARGIN = 1e-6


@pytest.fixture
def narrow_vae(monkeypatch):
    """The port pipelines the tools build get the narrow VAE (ch=32)."""
    monkeypatch.setattr(t_pipeline_mod, "VAEConfig", functools.partial(VAEConfig, ch=32))


def _yml(tmp_path, name, **params):
    """tiny-eval.yml with ``params`` changed, written to tmp_path."""
    cfg = load_config(TINY).to_dict()
    cfg["tokenizer"]["params"].update(params)
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(main, argv):
    """main(argv) -> (its returned dict, the JSON of its last printed line)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = main(argv)
    return res, json.loads(buf.getvalue().strip().splitlines()[-1])


def _argv_measure_k1024(tmp_path):
    return ["--yml-path", TINY, "--data_size", "64", "--batch", "2", "--reps", "2",
            "--iters", "1", "--out", str(tmp_path / "k.jsonl"), "--note", "cpu test"]


def _check_measure_k1024(line, tmp_path):
    assert {"ts", "build_s", "platform", "card", "rates_img_per_s", "median", "note"} <= set(line)
    assert line["k"] == 1024 and line["vq_rows"] == 2048 and len(line["rates_img_per_s"]) == 2
    assert line["median"] == sorted(line["rates_img_per_s"])[1]
    assert json.loads((tmp_path / "k.jsonl").read_text().splitlines()[-1]) == line


def _argv_encode_serving(tmp_path):
    return ["--yml-path", TINY, "--data_size", "64", "--batch", "2", "--iters", "1"]


def _check_encode_serving(line, tmp_path):
    assert set(line["encode_images_per_s"]) == {"highest", "high", "default"}
    assert set(line["encoder_stage_images_per_s"]) == {"plain_fp32", "bf16_fp32_scores",
                                                       "bf16_serving"}
    assert 0.0 <= line["id_agreement_serving_vs_plain"] <= 1.0


def _argv_bisect(tmp_path):
    return ["--yml-path", TINY, "--batch", "2", "--iters", "1", "--prec", "highest"]


def _check_bisect(line, tmp_path):
    names = [r["variant"] for r in line["rows"]]
    assert names[:3] == ["full (plain sdpa)", "full (kernel)", "real trunk (_dual_trunk, serving)"]
    assert {"-softmax", "-qattn", "-qmlp", "-xstream", "-adaln", "-norms", "-qattn-qmlp",
            "-all big", "adaLN hoisted"} <= set(names)
    assert set(line["calibration"]) == {"bf16", "fp32"}
    # a CPU rate is never a share of the card's peak
    assert all(c["share_of_peak"] is None for c in line["calibration"].values())
    assert line["full_trunk_images_per_s"] > 0


def _argv_flash(tmp_path):
    return ["--shape", "2,2,64,96", "--iters", "1", "--dtype", "float32"]


def _check_flash(line, tmp_path):
    (row,) = line["rows"]
    assert {"kernel_calls_per_s", "plain_calls_per_s", "sdpa_calls_per_s",
            "kernel_over_sdpa"} <= set(row)
    assert [s[0] for s in bench_flash.SHAPES] == [
        "mmdit_256px", "mmdit_512px_b1", "mmdit_512px_b2", "encoder_q", "renderer",
        "jax_note_4608"]


def _argv_decode512(tmp_path):
    # K = 256: the decode is bucketed by 128-token contexts, as the flagship's is
    return ["--yml-path", _yml(tmp_path, "k256.yml", k=256, k_per_stage="96,92,36,24,8"),
            "--data_size", "128", "--steps", "6", "--iters", "1"]


def _check_decode512(line, tmp_path):
    assert line["segments"] and line["segments"][0][0] == 0 and line["segments"][-1][1] == 6
    assert set(line["variants"]) == {"kernel", "serving_attention_false", "plain_attention"}
    # the port takes the kernel route at every length either way
    assert line["variants"]["serving_attention_false"]["max_abs_diff_vs_first"] == 0.0
    # plain bf16 attention rounds its weights to bf16 before P V: within the
    # largest difference tests/torch_port_helpers.py::assert_images_close allows
    assert line["variants"]["plain_attention"]["max_abs_diff_vs_first"] <= 1e-1


def _argv_int8(tmp_path):
    return ["--tiny", TINY, "--steps", "3", "--batch", "2", "--iters", "1"]


def _check_int8(line, tmp_path):
    assert {"bf16_img_per_s", "int8_img_per_s", "speedup", "psnr_int8_vs_bf16_db", "steps",
            "batch", "platform", "q8_matmul_launches_per_int8_decode"} <= set(line)
    assert np.isfinite(line["psnr_int8_vs_bf16_db"])


def _argv_render_overlap(tmp_path):
    return ["--yml-path", _yml(tmp_path, "renderer.yml", model="MMDiT_XL_Renderer"),
            "--data_size", "64", "--batch", "2", "--iters", "3"]


def _check_render_overlap(line, tmp_path):
    assert set(line["loops"]) == {"fused", "split_inorder", "split_pipelined"}
    assert line["images_equal"] is True


def _argv_train(tmp_path):
    return ["--yml-path", TINY, "--depth", "2", "--batch-size", "2", "--data_size", "64",
            "--iters", "1"]


def _check_train(line, tmp_path):
    for label in ("flash", "xla_attn"):
        assert {f"{label}_step_s", f"{label}_images_per_s", f"{label}_tflops",
                f"{label}_loss"} <= set(line)
        assert line[f"{label}_share_of_peak"] is None and np.isfinite(line[f"{label}_loss"])
    assert line["remat"] is True and line["hidden"] == 128
    assert "fp32" in line["peak"]


def _argv_scaling(tmp_path):
    return ["--tiny", TINY, "--batch-per-chip", "2", "--iters", "1"]


def _check_scaling(line, tmp_path):
    assert line["metric"] == "dp_scaling" and line["world"] == 1
    assert set(line["results"]["1"]) == {"images_per_s", "per_chip", "efficiency"}
    assert line["results"]["1"]["efficiency"] == 1.0


def _argv_loader(tmp_path):
    return ["--n", "12", "--size", "64", "--batch", "4", "--threads", "2"]


def _check_loader(line, tmp_path):
    assert {"native_loader_img_per_s", "native_single_img_per_s", "pil_img_per_s",
            "tar_loader_img_per_s", "tar_decoder", "native_unavailable_reason"} <= set(line)
    assert line["tar_decoded"] == 12


TOOLS = {
    "measure_k1024": (measure_k1024, _argv_measure_k1024, _check_measure_k1024),
    "bench_encode_serving": (bench_encode_serving, _argv_encode_serving, _check_encode_serving),
    "bench_encoder_bisect": (bench_encoder_bisect, _argv_bisect, _check_bisect),
    "bench_flash": (bench_flash, _argv_flash, _check_flash),
    "bench_decode512": (bench_decode512, _argv_decode512, _check_decode512),
    "bench_int8": (bench_int8, _argv_int8, _check_int8),
    "bench_render_overlap": (bench_render_overlap, _argv_render_overlap, _check_render_overlap),
    "bench_train": (bench_train, _argv_train, _check_train),
    "bench_scaling": (bench_scaling, _argv_scaling, _check_scaling),
    "bench_loader": (bench_loader, _argv_loader, _check_loader),
}


@pytest.mark.parametrize("name", list(TOOLS))
def test_tool_main_prints_its_keys(name, tmp_path, narrow_vae):
    mod, argv, check = TOOLS[name]
    res, line = _run(mod.main, [*argv(tmp_path), *([] if name == "bench_loader" else
                                                   ["--device", "cpu"])])
    assert {k: v for k, v in res.items() if k != "ids"} == line
    check(line, tmp_path)


def test_the_tools_default_to_the_card():
    """Each tool's --device is 'cuda' unless the caller asks for the CPU,
    and 'cuda' without a CUDA device raises."""
    for name, (mod, _, _) in TOOLS.items():
        if name != "bench_loader":
            assert mod.build_parser().parse_args([]).device == "cuda", name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            measure_k1024.main(["--reps", "1"])


def test_int8_psnr_matches_jax():
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (3, 16, 16, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    b[1] = a[1]                       # an exact match: the 1e-12 floor on both sides
    want = float(np.mean(np.asarray(j_metrics.psnr(a, b))))
    got = bench_int8.psnr_db(torch.from_numpy(a), torch.from_numpy(b))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("depth,hidden", [(2, None), (3, 256)])
def test_train_config_and_flops_match_jax(depth, hidden):
    params = j_load_config(TINY).to_dict()["tokenizer"]["params"]
    got = bench_train.remat_config(tokenizer_config_from_params(params), depth, hidden)
    jtc = j_tok.tokenizer_config_from_params(params)
    width = hidden or 64 * depth
    want = dataclasses.replace(
        jtc, encoder=dataclasses.replace(jtc.encoder, gradient_checkpointing=True),
        decoder=dataclasses.replace(jtc.decoder, depth=depth, hidden_override=hidden,
                                    context_dim=width, use_checkpoint=True))
    assert dataclasses.asdict(got.decoder) == dataclasses.asdict(want.decoder)
    assert dataclasses.asdict(got.encoder) == dataclasses.asdict(want.encoder)
    assert got.decoder.hidden_size == want.decoder.hidden_size == width
    B = 8
    n_x = (want.latent_size // want.decoder.patch_size) ** 2
    j_fwd = j_flops.qformer_encoder_flops(want.encoder) + j_flops.mmdit_step_flops(
        want.decoder, n_x=n_x)
    assert bench_train.train_flops(got, B) == 3.0 * j_fwd * B
    plain = bench_train.without_remat(got)
    assert not plain.encoder.gradient_checkpointing and not plain.decoder.use_checkpoint


SCALING_WORKER = """
import os, sys
import numpy as np
rank, world, init, yml, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
os.environ["RANK"], os.environ["WORLD_SIZE"] = str(rank), str(world)
import functools
import torch
torch.set_num_threads(1)
import selftoktokenizer_tpu_torch.pipeline.pipeline as t_pipeline_mod
from selftoktokenizer_tpu_torch.models.vae import VAEConfig
from selftoktokenizer_tpu_torch.tools import bench_scaling
t_pipeline_mod.VAEConfig = functools.partial(VAEConfig, ch=32)   # the narrow VAE, as in the test
res = bench_scaling.main(["--tiny", yml, "--init-method", init, "--device", "cpu",
                          "--batch-per-chip", "2", "--iters", "1"])
assert res["world"] == world and set(res["results"]) == {"1", str(world)}
if rank == 0:
    np.save(out, res["ids"].numpy())
"""


def test_scaling_two_gloo_ranks_gather_the_one_rank_ids(tmp_path, narrow_vae):
    out = tmp_path / "ids.npy"
    outs = run_ranks(SCALING_WORKER, tmp_path, world=2, args=(TINY, out))
    line = json.loads(outs[0].strip().splitlines()[-1])
    assert line["backend"] == "gloo" and line["results"]["2"]["per_chip"] > 0
    gathered = np.load(out)
    pipe = common.seeded_pipeline(TINY, torch.device("cpu"), datasize=64, encode_only=True)
    images = common.uniform_images(4, 64, "cpu")
    ids, margins = pipe.encoding_margins(images)
    assert gathered.shape == (4, pipe.K)
    diff = gathered != ids.numpy()
    assert not np.any(diff & (margins.numpy() >= VQ_MARGIN)), int(diff.sum())


def _renderer_cfg_dict():
    cfg = load_config(TINY).to_dict()
    cfg["tokenizer"]["params"]["model"] = "MMDiT_XL_Renderer"
    return cfg


def test_render_loops_agree_and_match_jax():
    jpipe, tpipe = pipeline_pair(_renderer_cfg_dict(), steps=1, seed=52, decode_dtype=torch.bfloat16)
    rng = np.random.default_rng(8)
    ids = [rng.integers(0, 64, (2, 8)).astype(np.int32) for _ in range(3)]
    outs = {name: fn(ids) for name, fn in bench_render_overlap.loops(tpipe).items()}
    assert set(outs) == {"fused", "split_inorder", "split_pipelined"}
    for name, o in outs.items():
        assert len(o) == 3
        assert all(torch.equal(a, b) for a, b in zip(o, outs["fused"])), name
    for i, batch in enumerate(ids):
        j_lat, j_img = jax_render(jpipe, batch)
        _, t_lat = tpipe.decoding_with_renderer(batch, return_latents=True)
        assert torch.equal(tpipe.decode_latents(t_lat), outs["fused"][i])
        scale = float(np.abs(j_lat).max())
        assert np.abs(to_np(t_lat) - j_lat).max() <= 3e-2 * scale
        assert_images_close(outs["fused"][i], j_img)


def _root_tool(name):
    """A root ``tools/<name>.py`` of the reference, loaded from its file."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"root_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_merge_token_parts_matches_the_root_tool(tmp_path):
    from selftoktokenizer_tpu_torch.tools import merge_token_parts

    rng = np.random.default_rng(4)
    # rank 10 sorts after rank 2; rank 2 holds no row (and so no margins)
    for r, n in ((1, 3), (0, 2), (2, 0), (10, 1)):
        extra = {"margins": rng.random((n, 5)).astype(np.float32)} if n else {}
        np.savez(tmp_path / f"t.part{r}.npz", tokens=rng.integers(0, 99, (n, 5)).astype(np.int32),
                 paths=np.asarray([f"r{r}_{i}" for i in range(n)]), **extra)
    argv = ["--glob", str(tmp_path / "t.part*.npz")]
    _, got = _run(merge_token_parts.main, [*argv, "--out", str(tmp_path / "port.npz")])
    _, want = _run(_root_tool("merge_token_parts").main,
                   [*argv, "--out", str(tmp_path / "root.npz")])
    assert {**got, "out": None} == {**want, "out": None} and got["n"] == 6
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "root.npz")
    assert set(a.files) == set(b.files) == {"tokens", "paths", "margins"}
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])
    np.savez(tmp_path / "t.part3.npz", tokens=np.zeros((1, 5), np.int32), paths=np.asarray(["r0_0"]))
    with pytest.raises(SystemExit, match="duplicate"):
        merge_token_parts.main([*argv, "--out", str(tmp_path / "dup.npz")])


def test_summarize_convergence_matches_the_root_tool(tmp_path):
    from selftoktokenizer_tpu_torch.tools import summarize_convergence

    rng = np.random.default_rng(5)
    metrics = tmp_path / "m.jsonl"
    with open(metrics, "w") as f:
        for s in range(1, 9):
            f.write(json.dumps({"step": s, "loss_avg": float(rng.random()),
                                "dm_mse": float(rng.random()), "vq_perplexity": 10.0 + s,
                                "vq_commit_loss": float(rng.random()) / 10,
                                "vq_n_reactive": int(s % 3 == 0)}) + "\n")
        for s in (0, 4, 8):
            f.write(json.dumps({"step": s, "eval_latent_mse": float(rng.random()),
                                "eval_latent_snr_db": float(rng.random() * 10)}) + "\n")
    texts = []
    for main in (summarize_convergence.main, _root_tool("summarize_convergence").main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            main(str(metrics))
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and "steps logged: 8 (to 8), all finite: True" in texts[0]


def test_use_flash_attention_false_takes_plain_attention(monkeypatch):
    """The route bench_train and bench_decode512 compare the kernel with:
    the decoder's attention through plain ``sdpa_key_mask``, the kernel
    router never called (fp32: the two agree to fp32 rounding)."""
    from selftoktokenizer_tpu_torch.models import mmdit as t_mm
    from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_

    cfg = tokenizer_config_from_params(dict(load_config(TINY).tokenizer.params)).decoder
    model = t_mm.MMDiT(cfg)
    init_weights_(model, common.generator("cpu", 3), zero_init_std=0.02)
    g = common.generator("cpu", 4)
    x = torch.randn((2, 8, 8, 16), generator=g)
    t = torch.tensor([0.3, 0.9])
    ehs = torch.randn((2, cfg.K, cfg.encoder_hidden_size), generator=g)
    mask = torch.arange(cfg.K)[None, :] < torch.tensor([[3], [8]])
    with torch.no_grad():
        want = t_mm.mmdit_apply(model, cfg, x, t, ehs, mask=mask)

        def refuse(*a, **k):
            raise AssertionError("the kernel router was called")

        monkeypatch.setattr(t_mm, "serving_attention", refuse)
        got = t_mm.mmdit_apply(model, dataclasses.replace(cfg, use_flash_attention=False), x, t,
                               ehs, mask=mask)
        with pytest.raises(AssertionError, match="router"):
            t_mm.mmdit_apply(model, cfg, x, t, ehs, mask=mask)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
