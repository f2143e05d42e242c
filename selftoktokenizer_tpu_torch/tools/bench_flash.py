"""The attention kernel against SDPA at the models' attention shapes
(counterpart of the reference ``tools/bench_flash.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_flash [--iters 50] \\
        [--dtype bfloat16|float32] [--shape B,H,Lq,Lk] [--device cuda]

Shapes, all at head dim 64, from the port's configs (``configs/flagship-256.yml``):

* ``mmdit_256px``: the 256 px decode's joint attention, 512 context + 256
  x rows, [4, 24, 768, 768];
* ``mmdit_512px_b1`` / ``mmdit_512px_b2``: the 512 px decode's, 512 + 1024
  rows, [1 | 2, 24, 1536, 1536];
* ``encoder_q``: the encoder's query attention, 512 queries over 256 image
  + 512 query keys, [16, 8, 512, 768];
* ``renderer``: the renderer's x rows over all keys, [8, 24, 768, 768];
* ``jax_note_4608``: [1, 24, 4608, 4608], the shape the reference's tool
  labels 512 px (4096 x rows: a 1024 px latent grid at patch 2), kept for
  comparison with its notes.

Key masks as in the reference: 30 % of the keys off at random, key 0 on.
Rates in calls a second (``utils.benchutil.rate_fn``, ending in
``torch.cuda.synchronize()``): the kernel (``ops.flash_attention.
flash_sdpa_key_mask``), its plain version, and
``F.scaled_dot_product_attention`` under the same boolean mask (a library
call the port uses nowhere). The reference's ``block_q`` sweep has no
counterpart: the port's tile and ring depth are constants of the kernel
(``csrc/flash_attention.cu``), and there is no knob to sweep. One JSON line
a shape, then one with every row and the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from selftoktokenizer_tpu_torch.tools import common

SHAPES = [
    ("mmdit_256px", 4, 24, 768, 768),
    ("mmdit_512px_b1", 1, 24, 1536, 1536),
    ("mmdit_512px_b2", 2, 24, 1536, 1536),
    ("encoder_q", 16, 8, 512, 768),
    ("renderer", 8, 24, 768, 768),
    ("jax_note_4608", 1, 24, 4608, 4608),
]
D = 64


def inputs(B, H, Lq, Lk, dtype, device, rng):
    """q, k, v normals and the reference's key mask (30 % off, key 0 on)."""
    def t(L):
        return torch.from_numpy(rng.standard_normal((B, H, L, D)).astype(np.float32)).to(
            device, dtype)

    mask = rng.random((B, Lk)) > 0.3
    mask[:, 0] = True
    return t(Lq), t(Lk), t(Lk), torch.from_numpy(mask).to(device)


def build_parser():
    p = argparse.ArgumentParser("bench_flash")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    p.add_argument("--shape", default=None,
                   help="one other shape 'B,H,Lq,Lk' instead of the list")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


@torch.no_grad()
def main(argv=None):
    """Run the tool; returns the dict of its last JSON line."""
    import torch.nn.functional as F

    from selftoktokenizer_tpu_torch.ops import flash_attention as fa
    from selftoktokenizer_tpu_torch.utils.benchutil import rate_fn

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    dt = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    shapes = [("custom", *map(int, args.shape.split(",")))] if args.shape else SHAPES
    rng = np.random.default_rng(0)
    rows = []
    for name, B, H, Lq, Lk in shapes:
        q, k, v, km = inputs(B, H, Lq, Lk, dt, device, rng)
        am = km[:, None, None, :]
        row = {"shape": name, "B": B, "H": H, "Lq": Lq, "Lk": Lk, "D": D, "dtype": args.dtype}

        def rate(fn):
            return rate_fn(fn, iters=args.iters, warm=2)

        row["kernel_calls_per_s"] = rate(lambda: fa.flash_sdpa_key_mask(q, k, v, km))
        row["plain_calls_per_s"] = rate(lambda: fa.flash_sdpa_key_mask_plain(q, k, v, km))
        row["sdpa_calls_per_s"] = rate(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=am))
        row["kernel_over_sdpa"] = row["kernel_calls_per_s"] / row["sdpa_calls_per_s"]
        common.emit(row)
        rows.append(row)
        del q, k, v, km, am
    return common.emit({"metric": "attention calls/s", "dtype": args.dtype, "iters": args.iters,
                        "card": common.card_line(device), "rows": rows,
                        "block_q_sweep": "none: the kernel's tile and ring depth are constants"})


if __name__ == "__main__":
    main()
