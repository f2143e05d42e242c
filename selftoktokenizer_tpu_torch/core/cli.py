"""The command-line flag set of the trainers and tools (counterpart of the
reference ``core/cli.py``): ``build_parser``, and ``parse_args``, where a
value the yml sets wins over the flag's.

The mesh flags keep the reference's names and give
``parallel/mesh.py::make_mesh`` its axis sizes (``--mesh-data`` -1: the
ranks the other two leave); a shape whose product is not the world size
raises ``ValueError``. ``--device``
(default ``cuda``) is where the run goes; ``--device cpu`` asks for the
CPU, as the tests do.
"""

from __future__ import annotations

import argparse

from selftoktokenizer_tpu_torch.core.config import AttrDict, load_config


def build_parser():
    p = argparse.ArgumentParser("selftoktokenizer_tpu_torch")
    p.add_argument("--yml-path", type=str, default=None,
                   help="YAML config (reference schema)")
    p.add_argument("--pretrained", type=str, default=None,
                   help="tokenizer checkpoint (.pth)")
    p.add_argument("--vae-path", type=str, default=None,
                   help="SD3 VAE checkpoint (first_stage_model .pt)")
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--output_path", type=str, default="output")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--cfg_scale", type=float, default=1.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run ('cpu' to run on the CPU)")
    # the mesh's shape (parallel/mesh.py::make_mesh)
    p.add_argument("--mesh-data", type=int, default=-1)
    p.add_argument("--mesh-fsdp", type=int, default=1)
    p.add_argument("--mesh-tensor", type=int, default=1)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--profile-dir", type=str, default="selftok_trace")
    p.add_argument("--profile_skip_first", type=int, default=1)
    p.add_argument("--profile_active", type=int, default=3)
    return p


def parse_args(argv=None):
    """(config, namespace): the flags land at the top level of the config,
    except where the yml already sets the key, whose value is kept. The raw
    flags stay under ``cfg.args``."""
    args = build_parser().parse_args(argv)
    cfg = AttrDict()
    if args.yml_path:
        cfg.update(load_config(args.yml_path))
    for k, v in vars(args).items():
        if k in cfg:          # the yml wins
            continue
        if v is not None:
            cfg[k] = v
    cfg["args"] = vars(args)
    return cfg, args
