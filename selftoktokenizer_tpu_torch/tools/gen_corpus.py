"""Synthetic-texture corpus for training runs (counterpart of the reference
``tools/gen_corpus.py``): each image composes a smooth gradient, oriented
sinusoid gratings, Gaussian blobs and a solid rectangle with random colours,
structure a codebook can specialise on with enough variety that memorising
it is not trivial.

    python -m selftoktokenizer_tpu_torch.tools.gen_corpus --out corpus/ --n 2048 \\
        --size 128 [--latents-out latents.npy --yml-path configs/conv-small.yml] \\
        [--device cuda]

The same ``--seed``, ``--n`` and ``--size`` give the reference tool's images
bit for bit (numpy only). With ``--latents-out`` the images, read back from
their PNGs, also go through the SD3 VAE in bf16 and
``SD3LatentFormat.process_in`` into one float32 array [N, s/8, s/8, 16].
The VAE is the port's seeded one (``common.seeded_vae`` from the config's
``random_seed``), the same that ``train_tokenizer`` encodes with when it is
given no ``--vae-path``, so a run on the file sees the latents the
on-the-fly path would.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from selftoktokenizer_tpu_torch.tools import common


def make_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """One synthetic image, float32 [H,W,3] in [-1,1]."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, size), np.linspace(-1, 1, size),
                         indexing="ij")
    img = np.zeros((size, size, 3), np.float32)

    # background: smooth linear gradient between two random colors
    c0, c1 = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi)
    ramp = (np.cos(ang) * xx + np.sin(ang) * yy + 2) / 4  # [0,1]
    img += c0 + (c1 - c0) * ramp[..., None].astype(np.float32)

    # oriented sinusoid gratings
    for _ in range(rng.integers(1, 4)):
        f = rng.uniform(2, 12)
        ang = rng.uniform(0, np.pi)
        ph = rng.uniform(0, 2 * np.pi)
        col = rng.uniform(-0.6, 0.6, 3).astype(np.float32)
        wave = np.sin(f * np.pi * (np.cos(ang) * xx + np.sin(ang) * yy) + ph)
        img += col * wave[..., None].astype(np.float32)

    # Gaussian blobs
    for _ in range(rng.integers(1, 5)):
        cx, cy = rng.uniform(-0.8, 0.8, 2)
        s = rng.uniform(0.05, 0.4)
        col = rng.uniform(-1, 1, 3).astype(np.float32)
        g = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s)))
        img += col * g[..., None].astype(np.float32)

    # solid axis-aligned rectangle (hard edges exercise high frequencies)
    if rng.uniform() < 0.7:
        x0, y0 = rng.integers(0, size - 8, 2)
        w, h = rng.integers(8, size // 2, 2)
        img[y0:y0 + h, x0:x0 + w] = \
            0.5 * img[y0:y0 + h, x0:x0 + w] + \
            0.5 * rng.uniform(-1, 1, 3).astype(np.float32)

    return np.clip(img, -1, 1)


def to_uint8(img):
    """[-1, 1] float image -> uint8, as the reference tool writes it."""
    return ((img + 1) * 127.5).round().clip(0, 255).astype(np.uint8)


def write_textures(out, n, size, seed):
    """Write tex_{i:06d}.png for i < n; returns the paths."""
    from PIL import Image

    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        path = os.path.join(out, f"tex_{i:06d}.png")
        Image.fromarray(to_uint8(make_texture(rng, size))).save(path)
        paths.append(path)
    return paths


def encode_paths(vae, cfg, paths, size, batch, device):
    """The images of ``paths`` (read back as the loaders read them) -> the
    tokenizer's latents [N, size/8, size/8, z] float32 numpy, ``batch``
    images an encode. vae: a bf16 module on ``device`` (``common.bf16_vae``)."""
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image

    out = []
    for i in range(0, len(paths), batch):
        chunk = np.concatenate([load_image(q, size) for q in paths[i:i + batch]])
        out.append(common.encode_to_latents(vae, cfg, chunk, device).cpu().numpy())
    return np.concatenate(out)


def build_parser():
    p = argparse.ArgumentParser("gen_corpus")
    p.add_argument("--out", required=True, help="PNG output directory")
    p.add_argument("--n", type=int, default=2048)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--latents-out", default=None,
                   help="also VAE-encode to one .npy latents array")
    p.add_argument("--yml-path", default="configs/conv-small.yml",
                   help="config supplying the VAE-init seed for --latents-out")
    p.add_argument("--batch", type=int, default=32,
                   help="VAE encode batch for --latents-out")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the image paths and, with --latents-out, the
    latents."""
    args = build_parser().parse_args(argv)
    paths = write_textures(args.out, args.n, args.size, args.seed)
    common.log(f"wrote {args.n} images to {args.out}")
    if not args.latents_out:
        return paths, None

    from selftoktokenizer_tpu_torch.core.config import load_config

    device = common.resolve_device(args.device)
    seed = load_config(args.yml_path).common.get("random_seed", 123)
    vae, cfg = common.seeded_vae(seed)
    arr = encode_paths(common.bf16_vae(vae, device), cfg, paths, args.size, args.batch, device)
    np.save(args.latents_out, arr)
    common.log(f"latents {arr.shape} std={arr.std():.3f} -> {args.latents_out}")
    return paths, arr


if __name__ == "__main__":
    main()
