"""The tokenizer's train step with both trunks rematerialised, its rate and
its share of the card's fp32 peak (counterpart of the reference
``tools/bench_train.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_train [--depth 12] \\
        [--hidden N] [--batch-size 8] [--iters 10] [--no-flash-ab] [--device cuda]

The flagship config (``configs/flagship-256.yml``, or ``--yml-path``) with
the reference's change: the decoder cut to ``--depth`` blocks, its width
``hidden = 64 x depth`` (or ``--hidden``, through ``hidden_override``),
``context_dim`` following the width, and both trunks rematerialised (the
encoder's ``gradient_checkpointing``, the decoder's ``use_checkpoint``:
each block's activations recomputed in the backward). ``--depth 24`` is
the flagship decoder (24 x 1536), which one 80 GB H100 holds with its
AdamW state at batch 8.

Weights: the port's seeded init (seed 0) with non-zero adaLN
(``init_weights_(zero_init_std=0.02)``). Batch: latents from numpy's
``default_rng(0)``, standard normal. The step (``train.trainer.train_step``:
flow loss, VQ EMA, AdamW) runs fp32 with TF32 off. Reports, for each
route: seconds a step over ``--iters`` steps after one warm step (host
clock ending in ``torch.cuda.synchronize()``), images a second, TFLOP/s
from ``utils/flops.py`` under the train convention (3 x the forward: the
encoder and one decoder pass; the remat recompute not counted) and its
share of the H100's fp32 peak (67 TFLOP/s, CUDA cores: the step's products
run in fp32 with TF32 off), the step's loss and peak memory.

Routes: ``flash`` (the attention kernel, forward and backward) and, unless
``--no-flash-ab``, ``xla_attn`` (``use_flash_attention=False``: plain
``sdpa_key_mask`` and its autograd backward, the reference's XLA route).
An out-of-memory error on the ``xla_attn`` route is written down as its
result; a failure on the kernel route is never caught. ``--donate`` is
kept for the reference's command line: the port's step updates its state
in place, so there is nothing to donate. One JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG, load_config
from selftoktokenizer_tpu_torch.tools import common


def remat_config(tcfg, depth, hidden=None):
    """The reference's change: decoder depth, width 64 x depth or
    ``hidden``, context_dim following it, both trunks rematerialised."""
    width = hidden or 64 * depth
    return dataclasses.replace(
        tcfg,
        encoder=dataclasses.replace(tcfg.encoder, gradient_checkpointing=True),
        decoder=dataclasses.replace(tcfg.decoder, depth=depth, hidden_override=hidden,
                                    context_dim=width, use_checkpoint=True))


def without_remat(tcfg):
    """The same config with neither trunk rematerialised."""
    return dataclasses.replace(
        tcfg, encoder=dataclasses.replace(tcfg.encoder, gradient_checkpointing=False),
        decoder=dataclasses.replace(tcfg.decoder, use_checkpoint=False))


def train_flops(tcfg, batch):
    """3 x (encoder forward + one decoder forward) x batch."""
    from selftoktokenizer_tpu_torch.utils import flops as F

    n_x = (tcfg.latent_size // tcfg.decoder.patch_size) ** 2
    return 3.0 * (F.qformer_encoder_flops(tcfg.encoder)
                  + F.mmdit_step_flops(tcfg.decoder, n_x=n_x)) * batch


def seeded_state(tcfg, tc, device, seed=0):
    """A train state over a fresh tokenizer of ``tcfg`` with the port's
    seeded weights (non-zero adaLN)."""
    from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer, init_weights_
    from selftoktokenizer_tpu_torch.train.trainer import make_train_state

    with torch.device(device):
        tok = ImageTokenizer(tcfg)
    init_weights_(tok, common.generator(device, seed), zero_init_std=0.02)
    return make_train_state(tok, tcfg, tc)


def latents(tcfg, batch, device):
    """[batch, h, w, 16] standard normals from numpy's default_rng(0)."""
    n = tcfg.latent_size
    a = np.random.default_rng(0).standard_normal((batch, n, n, 16)).astype(np.float32)
    return torch.from_numpy(a).to(device)


def build_parser():
    p = argparse.ArgumentParser("bench_train")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--depth", type=int, default=12,
                   help="decoder depth (the flagship's: 24); width 64 x depth")
    p.add_argument("--hidden", type=int, default=None,
                   help="decoder width instead of 64 x depth (hidden_override)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--no-flash-ab", action="store_true",
                   help="skip the use_flash_attention=False route")
    p.add_argument("--donate", action="store_true",
                   help="kept for the reference's command line; the port's step "
                        "updates its state in place")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params
    from selftoktokenizer_tpu_torch.ops.precision import fp32_exact
    from selftoktokenizer_tpu_torch.train.trainer import TrainConfig, train_step
    from selftoktokenizer_tpu_torch.utils import peaks
    from selftoktokenizer_tpu_torch.utils.benchutil import sync

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    cfg = load_config(args.yml_path)
    cfg.tokenizer.params.image_size = args.data_size
    tcfg = remat_config(tokenizer_config_from_params(dict(cfg.tokenizer.params)),
                        args.depth, args.hidden)
    tc = TrainConfig(dit_lr=1e-5, token_lr=5e-5)
    B = args.batch_size
    batch = latents(tcfg, B, device)
    flops = train_flops(tcfg, B)
    cuda = device.type == "cuda"

    def timed(tcfg_v, label):
        state = seeded_state(tcfg_v, tc, device)
        gen = common.generator(device, 0, 1)
        try:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            state, logs = train_step(state, tcfg_v, tc, batch, rng=gen)     # warm
            float(logs["loss"])
            sync()
            t0 = time.perf_counter()
            for _ in range(args.iters):
                state, logs = train_step(state, tcfg_v, tc, batch, rng=gen)
            sync()
            dt = (time.perf_counter() - t0) / args.iters
            share, peak = peaks.share(flops / dt, "fp32")
            if not cuda:
                share = None          # an H100 peak is no denominator of a CPU rate
            return {f"{label}_step_s": dt, f"{label}_images_per_s": B / dt,
                    f"{label}_tflops": flops / dt / 1e12, f"{label}_share_of_peak": share,
                    f"{label}_loss": float(logs["loss"]), "peak": peak,
                    f"{label}_peak_memory_gib":
                        torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None}
        finally:
            state.release()
            del state
            if cuda:
                torch.cuda.empty_cache()

    out = {"platform": device.type, "card": common.card_line(device), "depth": args.depth,
           "hidden": tcfg.decoder.hidden_size, "batch": B, "remat": True,
           "donate": args.donate, "precision": "fp32, TF32 off",
           # the model-FLOPs convention: the remat recompute (about one more
           # forward inside the backward) is not counted
           "train_flops_per_step_T": flops / 1e12}
    variants = [(tcfg, "flash")]
    if not args.no_flash_ab:
        variants.append((dataclasses.replace(tcfg, decoder=dataclasses.replace(
            tcfg.decoder, use_flash_attention=False)), "xla_attn"))
    with fp32_exact(True):
        for tcfg_v, label in variants:
            if label == "flash":
                out.update(timed(tcfg_v, label))
            else:
                try:
                    out.update(timed(tcfg_v, label))
                except torch.cuda.OutOfMemoryError as e:
                    # a result: plain attention's backward keeps [B, H, L, L]
                    # score tensors the kernel's never makes
                    out[f"{label}_error"] = f"{type(e).__name__}: {str(e)[:2000]}"
            print(f"{label}: {out.get(f'{label}_step_s')} s a step", flush=True)
    return common.emit(out)


if __name__ == "__main__":
    main()
