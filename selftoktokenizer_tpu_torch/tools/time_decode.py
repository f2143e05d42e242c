"""Warm 50-step decodes of the flagship at seeded random weights, on the
host's clock: the serving path's wall time, which host-side launch costs
move (the decode keeps the card idle most of the time).

    python -m selftoktokenizer_tpu_torch.tools.time_decode [--repeats 3]

Needs one NVIDIA GPU. For each decode type (bf16, int8): the pipeline of
the port's ``configs/flagship-256.yml`` at 256 px, the ids of 2 seeded images, one
decode of each form to warm up, then ``--repeats`` timed decodes of each
form: cfg 1.0 at batch 2 and cfg 2.0 at batch 1. Prints one JSON line a
decode type (every time and the median, in seconds), then the card's name
and power limit. To compare two trees, run it from each in turns in one
machine (a, b, b, a).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.pipeline import SelftokPipeline


def timed(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def main(argv=None):
    ap = argparse.ArgumentParser("time_decode", description=__doc__)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--types", nargs="+", default=["bf16", "int8"], choices=["bf16", "int8"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_decode: needs a CUDA device")
    res = {}
    for kind in args.types:
        pipe = SelftokPipeline(load_config(FLAGSHIP_CONFIG), datasize=256, steps=50,
                               decode_dtype=torch.bfloat16 if kind == "bf16" else "int8",
                               encode_precision="highest", seed=0, zero_init_std=0.02)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(7)
        images = torch.rand((2, 256, 256, 3), generator=gen, device="cuda") * 2 - 1
        noise = torch.randn((2, 32, 32, 16), generator=gen, device="cuda")
        ids = pipe.encoding(images)
        forms = {"cfg1_batch2": lambda: pipe.decoding(ids, noise=noise, cfg_scale=1.0),
                 "cfg2_batch1": lambda: pipe.decoding(ids[:1], noise=noise[:1], cfg_scale=2.0)}
        for fn in forms.values():
            fn()
        row = {}
        for name, fn in forms.items():
            secs = [timed(fn) for _ in range(args.repeats)]
            row[name] = {"s": secs, "median_s": statistics.median(secs)}
        res[kind] = row
        print(json.dumps({"decode": kind, **row}), flush=True)
        del pipe
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    return res


if __name__ == "__main__":
    main()
