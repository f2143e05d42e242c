"""The int8 decode against the bf16 decode: rate and PSNR between the two
reconstructions (counterpart of the reference ``tools/bench_int8.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_int8 [--steps 50] \\
        [--batch 4] [--iters 3] [--tiny YML] [--device cuda]

The flagship config (``configs/flagship-256.yml``) at 256 px with seeded
weights (non-zero adaLN), or with ``--tiny YML`` that config at 64 px; ids
from numpy's ``default_rng(0)``. Two pipelines on the same seed, hence the
same weights: ``decode_dtype=bfloat16`` and ``decode_dtype='int8'`` (the
bf16 decoder's projections quantized in place, through the ``q8_matmul``
kernel; attention through the attention kernel in both). Each decodes
once to warm up, then ``--iters`` times, the i-th from start noise of a
generator seeded i; the rate is images a second over those, ending in
``torch.cuda.synchronize()``, and the PSNR (``utils/metrics.py::psnr``,
the mean over the batch) is between the two last reconstructions, which
start from the same noise. Also counted: the ``q8_matmul`` and attention
launches of one int8 decode. One JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.tools import common


def bench_decode(pipe, ids, iters):
    """(images a second, the last images, (q8_matmul, attention) launches
    of the warm decode)."""
    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.ops import q8_matmul as q8
    from selftoktokenizer_tpu_torch.utils.benchutil import sync

    before = (q8.launch_count, fa.launch_count)
    out = pipe.decoding(ids)                          # warm
    sync()
    launches = (q8.launch_count - before[0], fa.launch_count - before[1])
    t0 = time.perf_counter()
    for i in range(iters):
        g = torch.Generator(device=pipe.device)
        g.manual_seed(i)
        out = pipe.decoding(ids, generator=g)
    sync()
    return ids.shape[0] * iters / (time.perf_counter() - t0), out, launches


def psnr_db(a, b):
    """The mean over the batch of ``utils.metrics.psnr`` (dB) of images in [0, 1]."""
    from selftoktokenizer_tpu_torch.utils.metrics import psnr

    return float(psnr(a.float(), b.float()).mean())


def build_parser():
    p = argparse.ArgumentParser("bench_int8")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--tiny", default=None, metavar="YML",
                   help="a small config (e.g. tests/data/tiny-eval.yml), decoded at 64 px")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    yml, datasize = (args.tiny, 64) if args.tiny else (FLAGSHIP_CONFIG, 256)
    cfg = load_config(yml)
    p = cfg.tokenizer.params
    ids = common.random_ids(args.batch, p.k, p.quantizer_config.codebook_size, device)

    res = {}
    for kind, dd in (("bf16", torch.bfloat16), ("int8", "int8")):
        pipe = common.seeded_pipeline(cfg, device, datasize=datasize, steps=args.steps,
                                      decode_dtype=dd)
        res[kind] = bench_decode(pipe, ids, args.iters)
        del pipe
        if device.type == "cuda":
            torch.cuda.empty_cache()
    (rate_bf16, out_bf16, _), (rate_int8, out_int8, (n_q8, n_attn)) = res["bf16"], res["int8"]
    return common.emit({
        "metric": "int8 decode A/B", "bf16_img_per_s": rate_bf16, "int8_img_per_s": rate_int8,
        "speedup": rate_int8 / rate_bf16, "psnr_int8_vs_bf16_db": psnr_db(out_int8, out_bf16),
        "q8_matmul_launches_per_int8_decode": n_q8,
        "attention_launches_per_int8_decode": n_attn,
        "steps": args.steps, "batch": args.batch, "data_size": datasize,
        "platform": device.type, "card": common.card_line(device)})


if __name__ == "__main__":
    main()
