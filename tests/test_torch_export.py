"""The port's exporter (``core/export.py``, ``tools/convert_ckpt.py``) against
the JAX package's ``core/export.py::tokenizer_to_state_dict`` on seeded
trees of ``tests/data/tiny-eval.yml`` (the tokenizer and its renderer) with
a seeded ``VQState``: the same names, shapes and fp32 values bit for bit,
the EMA payload included; both pipelines load the file. The hand-written
``.safetensors`` reader and writer (``utils/io.py``) against the
``safetensors`` package, both ways."""

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from selftoktokenizer_tpu.core import export as j_export
from selftoktokenizer_tpu.core.config import AttrDict as JAttrDict
from selftoktokenizer_tpu.core.config import load_config as j_load_config
from selftoktokenizer_tpu.models import tokenizer as j_tok
from selftoktokenizer_tpu.models import vae as j_vae
from selftoktokenizer_tpu.models import vq as j_vq
from selftoktokenizer_tpu.pipeline import SelftokPipeline as JaxPipeline
from selftoktokenizer_tpu_torch.core import checkpoint as ckpt
from selftoktokenizer_tpu_torch.core import convert, export
from selftoktokenizer_tpu_torch.core.config import AttrDict
from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline
from selftoktokenizer_tpu_torch.tools import convert_ckpt
from selftoktokenizer_tpu_torch.train import trainer
from selftoktokenizer_tpu_torch.train.vae import load_vae_params
from selftoktokenizer_tpu_torch.utils import io
from tests.torch_port_helpers import TINY, encoder_tables, mmdit_tables, seeded_tree, to_np


def _cfg_dict(renderer):
    cfg = j_load_config(TINY).to_dict()
    if renderer:
        cfg["tokenizer"]["params"]["model"] = "MMDiT_XL_Renderer"
    return cfg


@pytest.fixture(scope="module", params=["tokenizer", "renderer"])
def trees(request, tmp_path_factory):
    """(cfg dict, JAX config, live tree, EMA tree, JAX VQState, port
    tokenizer, its EMA parameters, port VQState, yml path)."""
    renderer = request.param == "renderer"
    cfg = _cfg_dict(renderer)
    jtc = j_tok.tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tables = {**encoder_tables(jtc.encoder, ("encoder",)), **mmdit_tables(jtc.decoder, ("model",))}
    tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 51 + renderer, tables)
    ema_tree = seeded_tree(lambda k: j_tok.tokenizer_init(k, jtc), 61 + renderer, tables)
    rng = np.random.default_rng(53)
    C, K = jtc.encoder.codebook_size, jtc.k
    embed = rng.standard_normal((C, 16)).astype(np.float32)
    state = j_vq.vq_state_init({"embed": embed / np.linalg.norm(embed, axis=-1, keepdims=True)},
                               K)._replace(
        cluster_size=rng.random(C).astype(np.float32),
        embed_avg=rng.standard_normal((C, 16)).astype(np.float32),
        timestep_p_over_c=rng.dirichlet(np.ones(C), K).astype(np.float32),
        count=rng.integers(0, 50, C).astype(np.float32),
        steps=np.int32(11), initted=np.bool_(True), tpc_initted=np.bool_(True))
    tcfg = tokenizer_config_from_params(cfg["tokenizer"]["params"])
    tok = convert.tokenizer_from_jax_tree(tree, tcfg)
    ema = dict(convert.tokenizer_from_jax_tree(ema_tree, tcfg).named_parameters())
    ema = {k: v.detach() for k, v in ema.items()}
    yml = tmp_path_factory.mktemp("yml") / "cfg.yml"
    import yaml

    yml.write_text(yaml.safe_dump(cfg))
    return (cfg, jtc, tree, ema_tree, state, tok, ema, convert.vq_state_from_jax(state),
            str(yml))


def _assert_bit_equal(got, want):
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        assert g.shape == w.shape, (k, g.shape, w.shape)
        assert g.dtype == np.float32, (k, g.dtype)
        np.testing.assert_array_equal(g, w.astype(np.float32), err_msg=k)


def test_export_equals_the_jax_exporter(trees):
    _, jtc, tree, _, state, tok, _, vq, _ = trees
    _assert_bit_equal(export.tokenizer_to_state_dict(tok, vq),
                      j_export.tokenizer_to_state_dict(tree, jtc, vq_state=state))
    # without a VQ state only the module's codebook goes out
    _assert_bit_equal(export.tokenizer_to_state_dict(tok),
                      j_export.tokenizer_to_state_dict(tree, jtc))


def test_ema_payload_equals_the_jax_exporter(trees):
    """The EMA weights with the state's codebook and buffers, as JAX's
    ``convert_ckpt export --ema`` writes them."""
    _, jtc, _, ema_tree, state, tok, ema, vq, _ = trees
    want = j_export.tokenizer_to_state_dict(ema_tree, jtc, vq_state=state)
    _assert_bit_equal(export.tokenizer_to_state_dict(tok, vq, params=ema), want)
    raw = {"params": tok.state_dict(), "ema_params": ema, "vq_state": vq.asdict(), "step": 3}
    _assert_bit_equal(export.train_state_to_state_dict(raw, ema=True, K=jtc.k), want)


def test_convert_ckpt_export_of_a_train_state_file(trees, tmp_path):
    """``save_train_state`` of a train state over the tokenizer -> the
    exporter's .pth and .safetensors, live and EMA."""
    cfg, jtc, tree, ema_tree, state, tok, ema, vq, yml = trees
    tcfg = tokenizer_config_from_params(cfg["tokenizer"]["params"])
    st = trainer.make_train_state(tok, tcfg, trainer.TrainConfig(ema_decay=0.5), vq_state=vq)
    for k, e in st.ema_params.items():
        e.copy_(ema[k])
    trainer.save_train_state(tmp_path / "step_3", st)
    for ema_flag, src_tree in ((False, tree), (True, ema_tree)):
        want = j_export.tokenizer_to_state_dict(src_tree, jtc, vq_state=state)
        extra = ["--ema"] if ema_flag else []
        for dst in (tmp_path / "tok.pth", tmp_path / "tok.safetensors"):
            convert_ckpt.main(["export", "--yml-path", yml, "--src", str(tmp_path / "step_3"),
                               "--dst", str(dst)] + extra)
            got = load_file(str(dst)) if dst.suffix == ".safetensors" else torch.load(dst)
            _assert_bit_equal(got, want)


def test_both_pipelines_load_the_export(trees, tmp_path):
    cfg, jtc, tree, _, state, tok, _, vq, _ = trees
    path = tmp_path / "export.pth"
    sd = export.tokenizer_to_state_dict(tok, vq)
    torch.save(sd, path)
    jpipe = JaxPipeline(JAttrDict(cfg), ckpt_path=str(path), datasize=64, steps=2)
    # the JAX pipeline keeps the weights (the file's codebook is the VQ
    # state's) and drops the EMA buffers
    got = j_export.tokenizer_to_state_dict(jpipe.params, jtc)
    assert set(got) == set(j_export.tokenizer_to_state_dict(tree, jtc))
    _assert_bit_equal(got, {k: sd[k].numpy() for k in got})
    tpipe = SelftokPipeline(AttrDict(cfg), ckpt_path=str(path), datasize=64, steps=2,
                            device="cpu")
    # no missing or unexpected key: every weight of the modules comes from the
    # file, every entry of the file lands in a weight or the VQ state
    own = {**{"encoder." + k: v for k, v in tpipe.encoder.state_dict().items()},
           **{"model." + k: v for k, v in tpipe.model.state_dict().items()}}
    q = "encoder.quantizer."
    assert set(sd) - set(own) == {q + k for k in export.vq_to_state_dict(vq, jtc.k)} - set(own)
    for k, v in own.items():
        assert torch.equal(v, sd[k]), k
    for f, v in tpipe.vq_state.asdict().items():
        np.testing.assert_array_equal(to_np(v), to_np(getattr(vq, f)), err_msg=f)


def test_convert_ckpt_tokenizer_round_trip(trees, tmp_path):
    """A reference .pth -> the port's checkpoint -> the exporter: the same
    dict; a .safetensors source too."""
    cfg, jtc, tree, _, state, _, _, _, yml = trees
    want = {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in j_export.tokenizer_to_state_dict(tree, jtc, vq_state=state).items()}
    torch.save(want, tmp_path / "ref.pth")
    io.save_safetensors(want, tmp_path / "ref.safetensors")
    for src in ("ref.pth", "ref.safetensors"):
        convert_ckpt.main(["tokenizer", "--yml-path", yml, "--src", str(tmp_path / src),
                           "--dst", str(tmp_path / "port.pt")])
        raw = ckpt.restore_checkpoint(tmp_path / "port.pt")
        assert "vq_state" in raw
        out = convert_ckpt.main(["export", "--yml-path", yml, "--src", str(tmp_path / "port.pt"),
                                 "--dst", str(tmp_path / "back.pth")])
        _assert_bit_equal(out, {k: v.numpy() for k, v in want.items()})


def test_convert_ckpt_vae_strips_the_prefix_and_loads_strictly(tmp_path):
    vtree = seeded_tree(lambda k: j_vae.vae_init(k, j_vae.VAEConfig(ch=32)), 57)
    sd = convert.vae_state_dict(vtree)
    io.save_safetensors({"first_stage_model." + k: v for k, v in sd.items()},
                        tmp_path / "vae.safetensors")
    convert_ckpt.main(["vae", "--src", str(tmp_path / "vae.safetensors"),
                       "--dst", str(tmp_path / "vae.pt")])
    vae, cfg = load_vae_params(tmp_path / "vae.pt")
    assert cfg.ch == 32
    for k, v in vae.state_dict().items():
        assert torch.equal(v, sd[k]), k
    del sd["decoder.conv_out.bias"]
    io.save_safetensors(sd, tmp_path / "short.safetensors")
    with pytest.raises(RuntimeError, match="conv_out.bias"):
        convert_ckpt.main(["vae", "--src", str(tmp_path / "short.safetensors"),
                           "--dst", str(tmp_path / "short.pt")])


def test_export_of_a_state_without_ema_refuses_ema(tmp_path):
    raw = {"params": {"encoder.query_tokens": torch.zeros(1, 8, 4)}, "step": 1}
    ckpt.save_checkpoint(tmp_path / "s", raw)
    with pytest.raises(SystemExit, match="ema_params"):
        convert_ckpt.main(["export", "--yml-path", TINY, "--src", str(tmp_path / "s"),
                           "--dst", str(tmp_path / "o.pth"), "--ema"])


DTYPES = [np.float32, np.float16, np.float64, np.int64, np.int32, np.int16, np.int8, np.uint8,
          np.bool_]


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_safetensors_both_ways_with_the_package(tmp_path, dtype):
    rng = np.random.default_rng(5)
    arrs = {"b.w": (rng.standard_normal((3, 5)) * 9).astype(dtype),
            "a": (rng.standard_normal((7,)) * 9).astype(dtype),
            "scalar": np.asarray(rng.standard_normal() * 9).astype(dtype),
            "empty": np.zeros((0, 4), dtype)}
    io.save_safetensors(arrs, tmp_path / "mine.safetensors", metadata={"format": "pt"})
    back = load_file(str(tmp_path / "mine.safetensors"))
    assert set(back) == set(arrs)
    for k, v in arrs.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    save_file(arrs, str(tmp_path / "pkg.safetensors"))
    got = io.load_safetensors(tmp_path / "pkg.safetensors")
    assert set(got) == set(arrs)
    for k, v in arrs.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_safetensors_bfloat16_both_ways(tmp_path):
    from safetensors.torch import load_file as t_load
    from safetensors.torch import save_file as t_save

    t = {"x": torch.randn(4, 3).bfloat16(), "y": torch.randn(2).bfloat16()}
    io.save_safetensors(t, tmp_path / "a.safetensors")
    back = t_load(str(tmp_path / "a.safetensors"))
    assert all(torch.equal(back[k], v) and back[k].dtype == torch.bfloat16 for k, v in t.items())
    t_save(t, str(tmp_path / "b.safetensors"))
    got = io.load_safetensors(tmp_path / "b.safetensors")
    assert all(torch.equal(got[k], v) and got[k].dtype == torch.bfloat16 for k, v in t.items())
