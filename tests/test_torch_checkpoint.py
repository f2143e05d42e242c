"""Reference ``.pth`` input on the CPU: files written with ``torch.save``
from the JAX package's exporter (``core/export.py::tokenizer_to_state_dict``
on a seeded tree, with the quantizer's EMA buffers) and from the port's
``vae_state_dict`` under ``first_stage_model.``, with and without each
prefix the reference loader takes, are loaded by the port's pipeline; the
same file is loaded into both pipelines, and ids and latents are held as
tests/test_torch_pipeline.py holds them. Also the port's own checkpoint
helpers (``core/checkpoint.py``)."""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import selftoktokenizer_tpu.pipeline.pipeline as j_pipeline_mod
from selftoktokenizer_tpu.core import export as j_export
from selftoktokenizer_tpu.core.config import AttrDict as JAttrDict
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.pipeline import SelftokPipeline as JaxPipeline
from selftoktokenizer_tpu_torch.core import checkpoint as ckpt
from selftoktokenizer_tpu_torch.core import convert
from selftoktokenizer_tpu_torch.core.config import AttrDict
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from tests.torch_port_helpers import (
    TINY, encoder_tables, jax_decode, mmdit_tables, seeded_tree, to_np)

LATENT_TOL = 1e-3


def _torch_sd(sd, prefix=""):
    return {prefix + k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pth")
    cfg = j_load_config(TINY).to_dict()
    jtc = j_tok.tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 21, tables)
    ema_tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 22, tables)
    rng = np.random.default_rng(23)
    C, K = jtc.encoder.codebook_size, jtc.k
    state = j_vq.vq_state_init({"embed": tree["encoder"]["quantizer"]["embed"]}, K)._replace(
        cluster_size=rng.random(C).astype(np.float32),
        embed_avg=rng.standard_normal((C, 16)).astype(np.float32),
        timestep_p_over_c=rng.dirichlet(np.ones(C), K).astype(np.float32),
        count=rng.integers(0, 50, C).astype(np.float32),
        steps=np.int32(7), initted=np.bool_(True), tpc_initted=np.bool_(True))
    sd = _torch_sd(j_export.tokenizer_to_state_dict(tree, jtc, vq_state=state))
    ema_sd = _torch_sd(j_export.tokenizer_to_state_dict(ema_tree, jtc), "ema_state_dict.")
    vae_tree = seeded_tree(lambda k: j_vae.vae_init(k, j_vae.VAEConfig(ch=32)), 24)
    paths = {name: d / f"{name}.pth" for name in ("plain", "state_dict", "module", "ema", "vae")}
    torch.save(sd, paths["plain"])
    torch.save({"state_dict": sd, "epoch": 3, "note": "trainer metadata"}, paths["state_dict"])
    torch.save({"module." + k: v for k, v in sd.items()}, paths["module"])
    torch.save({**sd, **ema_sd}, paths["ema"])
    torch.save(_torch_sd(convert.vae_state_dict(vae_tree), "first_stage_model."), paths["vae"])
    return cfg, jtc, tree, ema_tree, state, vae_tree, paths


def _port(cfg, **kw):
    return SelftokPipeline(AttrDict(cfg), datasize=64, steps=2, device="cpu", **kw)


@pytest.mark.parametrize("variant", ["plain", "state_dict", "module", "ema", "ema_decoder",
                                     "encode_only"])
def test_every_prefix_loads_the_weights(files, variant):
    cfg, jtc, tree, ema_tree, state, vae_tree, paths = files
    path = paths["ema" if variant.startswith("ema") else
                 "plain" if variant == "encode_only" else variant]
    pipe = _port(cfg, ckpt_path=str(path), vae_path=str(paths["vae"]),
                 ema_decoder=variant == "ema_decoder", encode_only=variant == "encode_only")
    want = convert.tokenizer_state_dict(ema_tree if variant == "ema_decoder" else tree,
                                        pipe.tcfg)
    got = {**{"encoder." + k: v for k, v in pipe.encoder.state_dict().items()},
           **({} if pipe.model is None else
              {"model." + k: v for k, v in pipe.model.state_dict().items()})}
    if variant == "encode_only":
        assert pipe.model is None
        want = {k: v for k, v in want.items() if k.startswith("encoder.")}
    assert set(got) == set(want)
    for k, v in got.items():
        if k.endswith("_codebook.embed") and variant != "ema_decoder":
            continue                  # the file holds the VQ state's codebook
        assert torch.equal(v, want[k]), k
    # the quantizer's EMA buffers become the pipeline's VQ state (the EMA
    # copy in the file holds none)
    if variant == "ema_decoder":
        assert pipe.vq_state is None
    else:
        assert torch.equal(pipe.encoder.quantizer.embed, torch.from_numpy(np.array(state.embed)))
        assert int(pipe.vq_state.steps) == 7 and bool(pipe.vq_state.initted)
        assert torch.equal(pipe.vq_state.count, torch.from_numpy(state.count))
    vae_want = convert.vae_state_dict(vae_tree)
    assert pipe.vae.cfg.ch == 32
    for k, v in pipe.vae.state_dict().items():
        assert torch.equal(v, vae_want[k]), k


def test_vq_state_from_the_file_matches_the_reference(files):
    cfg, jtc, _, _, _, _, paths = files
    sd = torch.load(paths["plain"])
    q = "encoder.quantizer."
    want = j_vq.vq_state_from_state_dict(
        {k[len(q):]: v.numpy() for k, v in sd.items() if k.startswith(q)}, jtc.k)
    got = _port(cfg, ckpt_path=str(paths["plain"]), encode_only=True).vq_state
    for f, v in got.asdict().items():
        np.testing.assert_array_equal(to_np(v), np.asarray(getattr(want, f)), err_msg=f)


def test_one_file_gives_both_pipelines_the_same_ids_and_latents(files):
    cfg, *_, paths = files
    with mock.patch.object(j_pipeline_mod, "VAEConfig",
                           functools.partial(j_vae.VAEConfig, ch=32)):
        jpipe = JaxPipeline(JAttrDict(cfg), ckpt_path=str(paths["plain"]),
                            vae_path=str(paths["vae"]), datasize=64, steps=2)
    tpipe = _port(cfg, ckpt_path=str(paths["plain"]), vae_path=str(paths["vae"]))
    rng = np.random.default_rng(2)
    images = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    noise = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    j_ids, j_marg = (to_np(a) for a in jpipe.encoding_margins(images))
    t_ids, t_marg = (to_np(a) for a in tpipe.encoding_margins(images))
    # the margin rule of tests/test_torch_pipeline.py: the bf16 VAE rounds
    # differently on the two sides, so ids must agree wherever the JAX
    # margin exceeds twice the largest shift of the margins (at least 0.05)
    same = t_ids == j_ids
    thr = max(0.05, 2.0 * float(np.abs(t_marg - j_marg)[same].max()))
    safe = j_marg > thr
    assert safe.mean() >= 0.25
    np.testing.assert_array_equal(t_ids[safe], j_ids[safe])
    np.testing.assert_array_equal(to_np(tpipe.encoding(images)), t_ids)
    j_lat, _ = jax_decode(jpipe, j_ids[:2], noise)
    _, t_lat = tpipe.decoding(j_ids[:2], noise=noise, return_latents=True)
    np.testing.assert_allclose(to_np(t_lat), j_lat, rtol=LATENT_TOL, atol=LATENT_TOL)


def test_a_missing_weight_fails_the_strict_load(files, tmp_path):
    cfg, *_, paths = files
    sd = torch.load(paths["plain"])
    del sd["model.final_layer.linear.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(RuntimeError, match="final_layer.linear.weight"):
        _port(cfg, ckpt_path=str(tmp_path / "short.pth"))


def test_checkpoint_round_trip_partial_merge_and_ema(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.int32),
                                                        "d": [torch.zeros(2), 5]}, "step": 3}
    path = tmp_path / "tree.pt"
    ckpt.save_checkpoint(path, tree)
    assert not (tmp_path / "tree.pt.tmp").exists()
    raw = ckpt.restore_checkpoint(path)
    assert torch.equal(raw["a"], tree["a"]) and torch.equal(raw["b"]["c"], tree["b"]["c"])
    assert raw["b"]["d"][1] == 5 and raw["step"] == 3

    params = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    said = []
    merged = ckpt.partial_merge(params, {"w": torch.ones(2, 2), "b": torch.ones(3),
                                         "x": torch.ones(1)}, log=said.append)
    assert torch.equal(merged["w"], torch.ones(2, 2)) and torch.equal(merged["b"], torch.zeros(2))
    assert "x" not in merged and any("unexpected" in s for s in said)
    assert any("dropped" in s for s in said)
    ema = {"w": torch.full((2,), 2.0)}
    ckpt.ema_update(ema, {"w": torch.full((2,), 4.0)}, decay=0.75)
    assert torch.equal(ema["w"], torch.full((2,), 2.5))
