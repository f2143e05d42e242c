"""The port's flag set and small utilities against the JAX package's:
``core/cli.py`` (yml values win over flags), ``utils/io.py`` and
``utils/logging.py``."""

import os

import pytest

from selftoktokenizer_tpu.core import cli as j_cli
from selftoktokenizer_tpu.utils import io as j_io
from selftoktokenizer_tpu.utils import logging as j_logging
from selftoktokenizer_tpu_torch.core import cli
from selftoktokenizer_tpu_torch.parallel.mesh import make_mesh
from selftoktokenizer_tpu_torch.utils import io as t_io
from selftoktokenizer_tpu_torch.utils import logging as t_logging
from tests.torch_port_helpers import TINY


@pytest.mark.parametrize("argv", [
    [], ["--yml-path", TINY], ["--yml-path", TINY, "--steps", "7", "--batch-size", "3"],
    ["--mesh-fsdp", "2", "--seed", "5", "--cfg_scale", "2.0"]])
def test_parse_args_matches_jax(argv):
    cfg, args = cli.parse_args(argv)
    jcfg, jargs = j_cli.parse_args(argv)
    assert args.device == "cuda" and cli.parse_args(argv + ["--device", "cpu"])[1].device == "cpu"
    got = {k: v for k, v in vars(args).items() if k not in ("device", "profile_dir")}
    want = {k: v for k, v in vars(jargs).items() if k != "profile_dir"}
    assert got == want
    skip = ("args", "device", "profile_dir")
    assert {k: v for k, v in cfg.to_dict().items() if k not in skip} == \
        {k: v for k, v in jcfg.to_dict().items() if k not in skip}


def test_yml_value_wins_over_the_flag(tmp_path):
    yml = tmp_path / "c.yml"
    yml.write_text("steps: 12\ncommon:\n  random_seed: 1\n")
    cfg, args = cli.parse_args(["--yml-path", str(yml), "--steps", "30"])
    assert cfg.steps == 12 and args.steps == 30 and cfg.args["steps"] == 30
    assert cfg.common.random_seed == 1 and cfg.seed == 123


def test_mesh_flags_above_one_raise():
    # one process is a world of one: a mesh of 2 or 4 ranks is not its shape
    _, args = cli.parse_args(["--mesh-fsdp", "2"])
    with pytest.raises(ValueError, match="fsdp=2.*world size 1"):
        make_mesh(args.mesh_data, args.mesh_fsdp, args.mesh_tensor)
    _, args = cli.parse_args(["--mesh-tensor", "4"])
    with pytest.raises(ValueError, match="tensor=4.*world size 1"):
        make_mesh(args.mesh_data, args.mesh_fsdp, args.mesh_tensor)


def test_io_helpers_match_jax(tmp_path):
    for rel in ("b/x.PNG", "a/y.jpg", "a/z.txt", "c/d/w.jpeg", "v.png"):
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"")
    for suf in (None, (".png", ".jpg", ".jpeg"), (".txt",)):
        assert t_io.walk_all_files(str(tmp_path), suf) == j_io.walk_all_files(str(tmp_path), suf)
    obj = {"a": [1, 2], "b": {"c": "d"}}
    t_io.write_to_yaml(obj, tmp_path / "o.yml")
    assert j_io.read_from_yaml(tmp_path / "o.yml") == t_io.read_from_yaml(tmp_path / "o.yml") == obj
    t_io.pickle_dump(obj, tmp_path / "o.pkl")
    assert t_io.pickle_load(tmp_path / "o.pkl") == obj
    assert t_io.mkdirs(str(tmp_path / "n" / "m")) == str(tmp_path / "n" / "m")
    assert os.path.isdir(tmp_path / "n" / "m")


def test_logging_helpers_match_jax():
    t, j = t_logging.AverageMeter("psnr"), j_logging.AverageMeter("psnr")
    for v, n in ((3.0, 2), (5.5, 3), (1.25, 1)):
        t.update(v, n)
        j.update(v, n)
    assert (t.sum, t.count, t.avg, str(t)) == (j.sum, j.count, j.avg, str(j))
    reg = t_logging.Registry("models")

    @reg.register
    def tiny():
        return 1

    reg.register(lambda: 2, name="other")
    assert reg.get("tiny")() == 1 and reg.get("other")() == 2
    with pytest.raises(KeyError):
        reg.register(tiny)
    with pytest.raises(KeyError):
        reg.get("missing")
    # outside a process group this is rank 0
    assert t_logging.rank_zero_only(lambda x: x + 1)(1) == 2
    with t_logging.Timer() as tm:
        pass
    assert tm.duration >= 0 and t_logging.time_since(0).endswith("s")
