"""Checkpoint conversion (counterpart of the reference ``tools/convert_ckpt.py``).

    python -m selftoktokenizer_tpu_torch.tools.convert_ckpt tokenizer --yml-path cfg.yml \\
        --src tokenizer_512.pth --dst tok512.pt
    python -m selftoktokenizer_tpu_torch.tools.convert_ckpt vae --src sd3_medium.safetensors \\
        --dst vae.pt
    python -m selftoktokenizer_tpu_torch.tools.convert_ckpt export --yml-path cfg.yml \\
        --src ckpt/step_10000 --dst tok.pth [--ema]

* ``tokenizer``: a reference ImageTokenizer / ImageRenderer ``.pth`` / ``.pt``
  / ``.safetensors`` is loaded strictly into the port's modules and written
  as the port's checkpoint (``core/checkpoint.py``): the module's state
  dict, and the quantizer's EMA state under ``vq_state`` when the file has
  its buffers.
* ``vae``: an SD3 VAE file (``first_stage_model.`` stripped when present)
  is loaded strictly into the port's VAE and written as a
  ``train/vae.py::save_vae_state`` file without optimizer state, which
  ``encode_corpus`` and the image-space evals read.
* ``export``: a ``save_train_state`` file (or a renderer trainer's
  checkpoint, or a ``tokenizer`` output) -> the reference-named state dict
  (``core/export.py``), the live weights or with ``--ema`` the EMA copy,
  as a ``.pth`` (``torch.save`` of the flat dict) or a ``.safetensors``
  (written by hand, ``utils/io.py``). The unmodified reference and the
  port's ``SelftokPipeline`` both load it.
"""

from __future__ import annotations

import argparse

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.tools import common


def build_parser():
    p = argparse.ArgumentParser("convert_ckpt")
    p.add_argument("kind", choices=["tokenizer", "vae", "export"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--ema", action="store_true",
                   help="export: write the EMA weights (the reference's 'ema_state_dict' "
                        "payload) instead of the live ones")
    return p


def _tcfg(yml_path):
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params

    return tokenizer_config_from_params(dict(load_config(yml_path).tokenizer.params))


def export(src, dst, yml_path, ema=False):
    """Write the reference-named state dict of a train state file; returns
    it."""
    from selftoktokenizer_tpu_torch.core.checkpoint import restore_checkpoint
    from selftoktokenizer_tpu_torch.core.export import train_state_to_state_dict
    from selftoktokenizer_tpu_torch.utils.io import save_safetensors

    raw = restore_checkpoint(src)
    if "params" not in raw:
        raise SystemExit(f"{src} is no train state (no 'params')")
    if ema and raw.get("ema_params") is None:
        raise SystemExit(f"{src} has no ema_params")
    out = train_state_to_state_dict(raw, ema=ema, K=_tcfg(yml_path).k)
    if dst.endswith(".safetensors"):
        save_safetensors(out, dst)
    else:
        torch.save(out, dst)
    n = sum(v.numel() for v in out.values())
    common.log(f"wrote {dst}: {len(out)} tensors, {n / 1e6:.1f}M params"
               f"{' (EMA)' if ema else ''}")
    return out


def convert(kind, src, dst, yml_path):
    """Load a reference file strictly into the port's module of ``kind``
    and write the port's checkpoint; returns the module."""
    from selftoktokenizer_tpu_torch.core.checkpoint import save_checkpoint
    from selftoktokenizer_tpu_torch.utils.io import load_state_dict_file

    sd = load_state_dict_file(src)
    if kind == "tokenizer":
        from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_from_state_dict

        module, vq_state = tokenizer_from_state_dict(sd, _tcfg(yml_path))
        tree = {"params": module.state_dict()}
        if vq_state is not None:
            tree["vq_state"] = vq_state.asdict()
    else:
        from selftoktokenizer_tpu_torch.models.vae import vae_from_state_dict

        p = "first_stage_model."
        if any(k.startswith(p) for k in sd):
            sd = {k[len(p):]: v for k, v in sd.items() if k.startswith(p)}
        module = vae_from_state_dict(sd)
        c = module.cfg
        tree = {"params": module.state_dict(), "step": 0,
                "config": {"ch": c.ch, "ch_mult": list(c.ch_mult),
                           "num_res_blocks": c.num_res_blocks, "z_channels": c.z_channels}}
    save_checkpoint(dst, tree)
    n = sum(p.numel() for p in module.parameters())
    common.log(f"wrote {dst}: {n / 1e6:.1f}M params")
    return module


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.kind == "export":
        return export(args.src, args.dst, args.yml_path, ema=args.ema)
    if args.ema:
        raise SystemExit("--ema is an export option")
    return convert(args.kind, args.src, args.dst, args.yml_path)


if __name__ == "__main__":
    main()
