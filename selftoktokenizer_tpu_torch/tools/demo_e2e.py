"""End-to-end demo of a trained stack (counterpart of the reference
``tools/demo_e2e.py``): images -> trained VAE encode -> trained tokenizer
ids -> (a) a diffusion decode and (b) the one-step renderer -> trained VAE
decode -> a PNG grid and each path's PSNR / SSIM.

    python -m selftoktokenizer_tpu_torch.tools.demo_e2e \\
        --tokenizer-ckpt tok_ckpt/step_20000 --renderer-ckpt ren_ckpt/step_4000 \\
        --latents-file lat.npy --n 8 --out demo_e2e.png [--json-out demo.jsonl] \\
        [--device cuda]

Grid rows: GT | VAE round trip (the ceiling) | diffusion decode | renderer.
The latents file's ``.meta.json`` sidecar (``encode_corpus``) names the
trained VAE, the corpus images and the latent normalisation; the images
are the last ``--n`` of the corpus. The checkpoints are the drivers' own
(``train_tokenizer``'s ``save_train_state`` file, ``train_renderer``'s
checkpoint); ``--ema`` takes their EMA weights. The tokenizer encodes at
'highest' (fp32, TF32 off) and the decodes run in fp32.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from selftoktokenizer_tpu_torch.tools import common

DECODE_NOISE = 0


def build_parser():
    p = argparse.ArgumentParser("demo_e2e")
    p.add_argument("--tokenizer-ckpt", required=True)
    p.add_argument("--renderer-ckpt", default=None)
    p.add_argument("--yml-path", default="configs/conv-small.yml")
    p.add_argument("--renderer-yml", default="configs/conv-small-renderer.yml")
    p.add_argument("--latents-file", required=True)
    p.add_argument("--n", type=int, default=8, help="held-out images (from the END of the corpus)")
    p.add_argument("--decode-steps", type=int, default=25)
    p.add_argument("--ema", action="store_true", help="the EMA weights of tokenizer and renderer")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "demo_e2e.png"))
    p.add_argument("--json-out", default=None)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def _tcfg(yml_path):
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params

    return tokenizer_config_from_params(dict(load_config(yml_path).tokenizer.params))


@torch.no_grad()
def run(args):
    """The demo; returns (its JSON record, {row name: images in [-1, 1]})."""
    from selftoktokenizer_tpu_torch.models.mmdit import renderer_apply
    from selftoktokenizer_tpu_torch.models.vae import vae_decode, vae_encode_mode
    from selftoktokenizer_tpu_torch.ops.precision import fp32_exact
    from selftoktokenizer_tpu_torch.pipeline.pipeline import encode_latents
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image, save_image
    from selftoktokenizer_tpu_torch.tools.certify_tiers import load_tokenizer
    from selftoktokenizer_tpu_torch.tools.train_tokenizer import (
        decode_sampler, diffusion_decode)
    from selftoktokenizer_tpu_torch.train.vae import load_vae_params
    from selftoktokenizer_tpu_torch.utils.io import walk_all_files
    from selftoktokenizer_tpu_torch.utils.metrics import psnr, ssim

    device = common.resolve_device(args.device)
    with open(args.latents_file + ".meta.json") as f:
        meta = json.load(f)
    vae, vcfg = load_vae_params(meta["vae_ckpt"])
    vae = common.bf16_vae(vae, device)
    sh, sc = meta["shift"], meta["scale"]
    tcfg = _tcfg(args.yml_path)
    tok, _ = load_tokenizer(args.tokenizer_ckpt, tcfg, args.ema, device)

    paths = walk_all_files(meta["images_dir"], common.IMAGE_EXT)[-args.n:]
    gt = torch.from_numpy(np.concatenate([load_image(q, meta["size"]) for q in paths])).to(device)
    # the trained VAE's latents, normalised: the tokenizer's input space
    z = (vae_encode_mode(vae, vcfg, gt.to(torch.bfloat16)).float() - sh) * sc

    def to_img(lat):
        img = vae_decode(vae, vcfg, (lat / sc + sh).to(torch.bfloat16))
        return torch.clamp(img.float(), -1, 1)

    rows = {"gt": gt, "vae": to_img(z)}
    ehs, ids = encode_latents(tok.encoder, tcfg.encoder, z, "highest")
    sched, step_k = decode_sampler(tcfg, args.decode_steps)
    noise = torch.randn(z.shape, generator=common.generator(device, DECODE_NOISE), device=device)
    with fp32_exact(True):
        rows["diffusion"] = to_img(diffusion_decode(tok, tcfg, ehs, noise, sched, step_k,
                                                    tcfg.context_see_xt))
    del tok
    if args.renderer_ckpt:
        rcfg = _tcfg(args.renderer_yml)
        ren, _ = load_tokenizer(args.renderer_ckpt, rcfg, args.ema, device)
        with fp32_exact(True):
            rows["renderer"] = to_img(renderer_apply(ren.model, rcfg.decoder, ehs))
        del ren

    res = {"n": args.n, "ema": bool(args.ema), "tokens_per_image": int(ids.shape[1])}
    a = (gt + 1) / 2
    for name, img in rows.items():
        if name == "gt":
            continue
        b = (img + 1) / 2
        res[f"{name}_psnr_db"] = round(float(torch.mean(psnr(a, b))), 2)
        res[f"{name}_ssim"] = round(float(torch.mean(ssim(a, b))), 4)
    grid = torch.cat([torch.cat(list(r), dim=1) for r in rows.values()], dim=0)
    save_image((grid + 1) / 2, args.out)
    res["grid"] = args.out
    res["grid_rows"] = list(rows)
    common.log(json.dumps(res))
    if args.json_out:
        with open(args.json_out, "a") as f:
            f.write(json.dumps(res) + "\n")
    return res, rows


def main(argv=None):
    """Run the demo; returns its JSON record."""
    return run(build_parser().parse_args(argv))[0]


if __name__ == "__main__":
    main()
