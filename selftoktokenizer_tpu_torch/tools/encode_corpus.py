"""Encode an image folder to normalised VAE latents with a trained VAE
(counterpart of the reference ``tools/encode_corpus.py``).

    python -m selftoktokenizer_tpu_torch.tools.encode_corpus --vae-ckpt vae.pt \\
        --images-dir corpus/ --out latents.npy [--size 128] [--batch 32] [--device cuda]

``--vae-ckpt`` is a ``train/vae.py::save_vae_state`` file. Writes one
float32 array [N, size/8, size/8, z] of latents normalised by the corpus,
``(raw - shift) * scale`` with ``shift`` the mean and ``scale`` 1 / std of
the raw latents (one scalar each, as SD3's latent constants were found),
and a sidecar ``<out>.meta.json`` with the normalisation and provenance;
invert with ``lat / scale + shift``. Row i is the i-th image of the sorted
path list. The VAE encodes in bf16, its mode (the posterior mean).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from selftoktokenizer_tpu_torch.data.native import to_device
from selftoktokenizer_tpu_torch.tools import common
from selftoktokenizer_tpu_torch.utils.io import walk_all_files


def build_parser():
    p = argparse.ArgumentParser("encode_corpus")
    p.add_argument("--vae-ckpt", required=True)
    p.add_argument("--images-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


@torch.no_grad()
def encode_latents(vae, cfg, images, device):
    """Raw bf16 VAE latents (the posterior mean) of [-1, 1] NHWC images
    (numpy), as float32 numpy."""
    from selftoktokenizer_tpu_torch.models.vae import vae_encode_mode

    x = to_device(images, device).to(torch.bfloat16)
    return vae_encode_mode(vae, cfg, x).float().cpu().numpy()


def main(argv=None):
    """Run the tool; returns the metadata it writes."""
    from selftoktokenizer_tpu_torch.train.vae import load_vae_params

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    vae, cfg = load_vae_params(args.vae_ckpt)
    vae = vae.to(device=device, dtype=torch.bfloat16).requires_grad_(False)
    paths = walk_all_files(args.images_dir, common.IMAGE_EXT)
    if not paths:
        raise SystemExit(f"no images in {args.images_dir}")
    load = common.load_fn(common.choose_loader())
    lat = [encode_latents(vae, cfg, np.concatenate([load(q, args.size)
                                                    for q in paths[i:i + args.batch]]), device)
           for i in range(0, len(paths), args.batch)]
    raw = np.concatenate(lat)
    shift = float(raw.mean())
    scale = float(1.0 / raw.std())
    np.save(args.out, ((raw - shift) * scale).astype(np.float32))
    meta = {"shift": shift, "scale": scale, "vae_ckpt": os.path.abspath(args.vae_ckpt),
            "images_dir": os.path.abspath(args.images_dir), "size": args.size,
            "n": len(paths), "raw_std": float(raw.std()), "raw_mean": shift}
    with open(args.out + ".meta.json", "w") as f:
        json.dump(meta, f, indent=1)
    print(f"latents {raw.shape} raw_std={raw.std():.3f} -> {args.out} (+ .meta.json)",
          flush=True)
    return meta


if __name__ == "__main__":
    main()
