"""The K=1024 encode at 'highest', measured again and again (counterpart of
the reference ``tools/measure_k1024.py``): its rate across sessions.

    python -m selftoktokenizer_tpu_torch.tools.measure_k1024 [--reps 3] \\
        [--out k1024_sessions.jsonl] [--note TEXT] [--device cuda]

The flagship config (``configs/flagship-256.yml``, or ``--yml-path``) with
the reference's change: ``k = 1024``, ``k_per_stage =
"384,368,144,96,32"``. Seeded weights (non-zero adaLN), an encode-only
pipeline; batch 32 of 256 px images from numpy's ``default_rng(0)``,
uniform in [-1, 1]. Each rep is ``batch x rate_fn(iters=10, warm=1)`` of
``pipe.encoding`` at 'highest' (fp32 trunk, TF32 off): one ``vq_argmax``
launch an encode over batch x 1024 = 32,768 rows against the 32,768-code
book. Prints each rep, then one JSON line (appended to ``--out`` as JSONL
when given) with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

from selftoktokenizer_tpu_torch.core.config import AttrDict, FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.tools import common

K = 1024
K_PER_STAGE = "384,368,144,96,32"


def k1024_config(cfg):
    """The config with the reference's K=1024 change (a copy)."""
    d = (load_config(cfg) if isinstance(cfg, str) else cfg).to_dict()
    d["tokenizer"]["params"]["k"] = K
    d["tokenizer"]["params"]["k_per_stage"] = K_PER_STAGE
    return AttrDict(d)


def build_parser():
    p = argparse.ArgumentParser("measure_k1024")
    p.add_argument("--reps", type=int, default=3,
                   help="within-process repeats of the 10-iter rate loop")
    p.add_argument("--out", default=None, help="append JSONL here")
    p.add_argument("--note", default="", help="free-text session context")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    import json
    import statistics

    from selftoktokenizer_tpu_torch.utils.benchutil import rate_fn

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    t0 = time.time()
    pipe = common.seeded_pipeline(k1024_config(args.yml_path), device, datasize=args.data_size,
                                  encode_only=True, encode_precision="highest")
    images = common.uniform_images(args.batch, args.data_size, device)
    build_s = time.time() - t0
    rates = []
    for i in range(args.reps):
        r = args.batch * rate_fn(lambda: pipe.encoding(images), iters=args.iters, warm=1)
        rates.append(r)
        print(f"rep {i}: {r:.2f} img/s", flush=True)
    rec = {"ts": time.time(), "build_s": build_s, "platform": device.type,
           "card": common.card_line(device), "k": pipe.K, "batch": args.batch,
           "vq_rows": args.batch * pipe.K, "codebook": pipe.tcfg.encoder.codebook_size,
           "precision": "highest", "rates_img_per_s": rates,
           "median": statistics.median_high(rates), "note": args.note}
    common.emit(rec)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
