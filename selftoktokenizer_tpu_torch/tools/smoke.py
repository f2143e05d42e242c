"""Smoke run of the whole path on one image (counterpart of the reference
``smoke.py``): image -> ids -> ``token.npy`` -> decode (the 50-step bf16
decode, or the one-step renderer) -> ``re_<b>_<size>.png``.

    python -m selftoktokenizer_tpu_torch.tools.smoke --image photo.jpg \\
        [--yml-path cfg.yml] [--pretrained tok.pth] [--vae-path sd3.pt] \\
        [--renderer] [--out-dir output] [--device cuda]

Without checkpoints the weights are seeded random (``--zero-init-std``
above 0 switches the attention gates on): the reconstruction is noise,
the path is the real one. Reading the image takes the C++ loader where it
can be built here, else PIL; writing the PNG takes PIL.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.pipeline.preprocess import save_image
from selftoktokenizer_tpu_torch.tools import common


def build_parser():
    p = argparse.ArgumentParser("smoke")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--pretrained", default=None)
    p.add_argument("--vae-path", default=None)
    p.add_argument("--image", required=True)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out-dir", default="output")
    p.add_argument("--renderer", action="store_true",
                   help="decode with the one-step renderer (a renderer config)")
    p.add_argument("--zero-init-std", type=float, default=0.0,
                   help="std of the seeded random leaves the reference zeroes "
                        "(adaLN, biases) when no checkpoint is given")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the paths of the PNGs it wrote."""
    from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline

    args = build_parser().parse_args(argv)
    pipe = SelftokPipeline(load_config(args.yml_path), ckpt_path=args.pretrained,
                           vae_path=args.vae_path, datasize=args.data_size, steps=args.steps,
                           decode_dtype=torch.bfloat16, zero_init_std=args.zero_init_std,
                           device=torch.device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    images = common.load_fn(common.choose_loader())(args.image, args.data_size)
    tokens = pipe.encoding(images).cpu().numpy()
    np.save(os.path.join(args.out_dir, "token.npy"), tokens)
    print(f"tokens: shape={tokens.shape} unique={len(np.unique(tokens))} -> token.npy",
          flush=True)

    tokens = np.load(os.path.join(args.out_dir, "token.npy"))
    if args.renderer or pipe.tcfg.decoder.renderer:
        recon = pipe.decoding_with_renderer(tokens)
    else:
        recon = pipe.decoding(tokens)
    written = []
    for b in range(recon.shape[0]):
        out = os.path.join(args.out_dir, f"re_{b}_{args.data_size}.png")
        save_image(recon[b:b + 1], out)
        written.append(out)
        print(f"wrote {out}", flush=True)
    return written


if __name__ == "__main__":
    main()
