"""The one-step renderer in three host loops (counterpart of the reference
``tools/bench_render_overlap.py``): does overlap between batches exist to
harvest on one card?

    python -m selftoktokenizer_tpu_torch.tools.bench_render_overlap \\
        [--batch 8] [--iters 10] [--device cuda]

The renderer config (``configs/flagship-renderer-256.yml``, or
``--yml-path``) at 256 px in bf16 with seeded weights (non-zero adaLN);
``--iters`` batches of ids from numpy's ``default_rng(0)``. The loops, all
on one CUDA stream with no synchronize between batches (one at the end of
a loop):

* ``fused``: ``SelftokPipeline.decoding_with_renderer`` per batch;
* ``split_inorder``: the two stages per batch in program order: the
  renderer (``_tokens_to_context`` + ``models.mmdit.renderer_apply``),
  then the VAE decode (``_latents_to_images``);
* ``split_pipelined``: the renderer of batch i + 1 issued before the VAE
  decode of batch i.

On one stream the card runs the kernels in issue order whatever the loop;
what the loops can change is how far the host runs ahead. A second
stream is out of scope (the reference's tool has none). Every loop's
images of every batch must equal the fused loop's. Rates: images a
second, the best of three runs. One JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_RENDERER_CONFIG
from selftoktokenizer_tpu_torch.tools import common


def loops(pipe):
    """name -> fn(list of id batches) -> list of image batches."""
    from selftoktokenizer_tpu_torch.models.mmdit import renderer_apply

    def stage_render(ids):
        return renderer_apply(pipe.model, pipe.tcfg.decoder, pipe._tokens_to_context(ids),
                              ctx_mods=pipe._ctx_mods)

    def stage_vae(lat):
        return pipe._latents_to_images(lat)

    def fused(ids):
        return [pipe.decoding_with_renderer(i) for i in ids]

    def split_inorder(ids):
        return [stage_vae(stage_render(i)) for i in ids]

    def split_pipelined(ids):
        lat = stage_render(ids[0])
        outs = []
        for nxt in ids[1:]:
            nxt_lat = stage_render(nxt)      # issued ahead
            outs.append(stage_vae(lat))
            lat = nxt_lat
        outs.append(stage_vae(lat))
        return outs

    def with_grad_off(fn):
        def run(ids):
            with torch.no_grad():
                return fn([pipe._to_device(i) for i in ids])
        return run

    return {"fused": with_grad_off(fused), "split_inorder": with_grad_off(split_inorder),
            "split_pipelined": with_grad_off(split_pipelined)}


def build_parser():
    p = argparse.ArgumentParser("bench_render_overlap")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--yml-path", default=FLAGSHIP_RENDERER_CONFIG)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.utils.benchutil import sync

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    pipe = common.seeded_pipeline(args.yml_path, device, datasize=args.data_size,
                                  decode_dtype=torch.bfloat16)
    B = args.batch
    ids = [common.random_ids(B, pipe.K, pipe.tcfg.encoder.codebook_size, device, seed=i)
           for i in range(args.iters)]
    fns = loops(pipe)
    for fn in fns.values():                     # warm every loop's kernels
        fn(ids[:2])
    sync()

    rates, outs = {}, {}
    for name, fn in fns.items():
        runs = []
        for _ in range(3):
            t0 = time.perf_counter()
            outs[name] = fn(ids)
            sync()
            runs.append(args.iters * B / (time.perf_counter() - t0))
        rates[name] = {"images_per_s": max(runs), "runs": runs}
        print(f"{name:>16}: {max(runs):7.2f} img/s  (runs: "
              + ", ".join(f"{r:.2f}" for r in runs) + ")", flush=True)
    ref = outs["fused"]
    diff = {name: max((a.float() - b.float()).abs().max().item() for a, b in zip(o, ref))
            for name, o in outs.items()}
    equal = all(torch.equal(a, b) for o in outs.values() for a, b in zip(o, ref))
    return common.emit({"batch": B, "iters": args.iters, "card": common.card_line(device),
                        "loops": rates, "max_abs_diff_vs_fused": diff, "images_equal": equal})


if __name__ == "__main__":
    main()
