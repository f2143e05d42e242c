"""The 512 px, 50-step bf16 decode at the flagship's full width, and the
attention routes of its decoder config (counterpart of the reference
``tools/bench_decode512.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_decode512 [--iters 2] \\
        [--batch 2] [--device cuda]

The flagship config (``configs/flagship-256.yml``, or ``--yml-path``;
``MMDiT_XL``, 24 blocks x 1536) with seeded weights (non-zero adaLN), a
bf16 decode at 512 px (a 64 x 64 latent, 1024 x rows) of ids from numpy's
``default_rng(0)``, batch 2, start noise from the pipeline's seed-0
generator. The decode is bucketed by context length
(``pipeline._decode_segments``): the tool prints the segments (start step,
end step, context length) and the attention launches one decode makes.

Variants, the routes the port's ``MMDiTConfig`` has: ``kernel`` (the
default: the joint attention through the attention kernel at every
length), ``serving_attention_false`` (the reference's switch from its
length-adaptive bf16 route to its kernel; the port takes the kernel at
every length either way, so this variant must give the same images) and
``plain_attention`` (``use_flash_attention=False``: plain
``sdpa_key_mask``). Every variant's images are held against the first
(largest absolute difference). The reference's ``block_q`` sweep and its
bf16-score crossover sweep have no counterpart: the port's kernel has no
query-tile knob and no crossover. Rates: images a second over ``--iters``
decodes after one warm decode, ending in ``torch.cuda.synchronize()``. One
JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.tools import common

VARIANTS = (("kernel", {}), ("serving_attention_false", {"serving_attention": False}),
            ("plain_attention", {"use_flash_attention": False}))


def build_parser():
    p = argparse.ArgumentParser("bench_decode512")
    p.add_argument("--iters", type=int, default=2)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--data_size", type=int, default=512)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.utils.benchutil import sync

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    pipe = common.seeded_pipeline(args.yml_path, device, datasize=args.data_size,
                                  steps=args.steps, decode_dtype=torch.bfloat16)
    B = args.batch
    ids = common.random_ids(B, pipe.K, pipe.tcfg.encoder.codebook_size, device)
    dcfg = pipe.tcfg.decoder
    segments = pipe._decode_segments()
    print(f"decode segments (start, end, context length): {segments}", flush=True)

    def rate():
        before = fa.launch_count
        out = pipe.decoding(ids)
        sync()
        launches = fa.launch_count - before
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = pipe.decoding(ids)
        sync()
        return args.iters * B / (time.perf_counter() - t0), out, launches

    results, first = {}, None
    for name, change in VARIANTS:
        keep = {k: getattr(dcfg, k) for k in change}
        for k, v in change.items():
            setattr(dcfg, k, v)
        try:
            r, out, launches = rate()
        finally:
            for k, v in keep.items():
                setattr(dcfg, k, v)
        if first is None:
            first = out
        diff = (out.float() - first.float()).abs().max().item()
        results[name] = {"images_per_s": r, "attention_launches_per_decode": launches,
                         "max_abs_diff_vs_first": diff}
        print(f"{name}: {r:.4f} img/s, {launches} attention launches a decode, "
              f"max abs diff from the first variant {diff:.4g}", flush=True)
    return common.emit({
        "data_size": args.data_size, "batch": B, "steps": args.steps, "iters": args.iters,
        "card": common.card_line(device),
        "segments": [list(s) for s in segments] if segments else None,
        "joint_lengths": sorted({dcfg.register_length + s[2] + (args.data_size // 8 //
                                 dcfg.patch_size) ** 2 for s in segments or []}, reverse=True),
        "variants": results,
        "sweeps": "none: no query-tile knob and no crossover in the port's kernel"})


if __name__ == "__main__":
    main()
