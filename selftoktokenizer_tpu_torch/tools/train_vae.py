"""Train the SD3-architecture VAE on an image folder (counterpart of the
reference ``tools/train_vae.py``).

    python -m selftoktokenizer_tpu_torch.tools.train_vae --data-dir corpus/ --size 128 \\
        --steps 20000 --batch-size 32 --ckpt-dir vae_ckpt [--metrics-out m.jsonl] \\
        [--device cuda]

The reference's pipeline uses a frozen pretrained SD3 VAE, which the
repository does not ship; this trains the same architecture
(``models/vae.py``, width ``--ch``) on a corpus such as ``gen_corpus``'s.
The checkpoint (``train/vae.py::save_vae_state``) feeds ``encode_corpus``
and the drivers' image-space evals.

Held-out protocol: the last ``--holdout`` images of the sorted path list are
never trained on; each eval reports the deterministic encode -> decode PSNR
and SSIM of the first ``--eval-batch`` of them. The corpus is held in host
memory as uint8; each pass permutes the training rows by
``default_rng(seed)`` (one generator over the run), and a batch gathers its
rows sorted. Step i's reparametrisation noise comes from a generator seeded
by (seed, 10000 + i).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from selftoktokenizer_tpu_torch.data.native import to_device
from selftoktokenizer_tpu_torch.tools import common

NOISE_STREAM = 10_000


def build_parser():
    p = argparse.ArgumentParser("train_vae")
    p.add_argument("--data-dir", required=True)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--steps", type=int, default=20000)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup", type=int, default=500)
    p.add_argument("--kl-weight", type=float, default=1e-6)
    p.add_argument("--grad-norm", type=float, default=1.0)
    p.add_argument("--ch", type=int, default=64,
                   help="base width (SD3 ships 128); a multiple of 32")
    p.add_argument("--ch-mult", default="1,2,4,4")
    p.add_argument("--res-blocks", type=int, default=2)
    p.add_argument("--holdout", type=int, default=64, help="last N images held out of training")
    p.add_argument("--eval-batch", type=int, default=32,
                   help="held-out images per eval (the first N of the holdout)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--eval-interval", type=int, default=1000)
    p.add_argument("--ckpt-interval", type=int, default=5000)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "vae_ckpt"))
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--sample-out", default=None,
                   help="save a held-out GT/recon PNG pair at the end")
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def load_u8(paths, size):
    """The images as one uint8 array [N, size, size, 3]."""
    from selftoktokenizer_tpu_torch.pipeline.preprocess import load_image

    return np.stack([((load_image(q, size)[0] + 1) * 127.5).round().clip(0, 255)
                     .astype(np.uint8) for q in paths])


def to_float(u8):
    return u8.astype(np.float32) / 127.5 - 1.0


def batch_indices(n_train, batch, seed):
    """The sorted row indices of each batch, pass after pass: one
    ``default_rng(seed)`` permutes the rows at each pass."""
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n_train)
        for i in range(0, n_train - batch + 1, batch):
            yield np.sort(order[i:i + batch])


def train(args):
    """The training loop. Returns the final JSON line's dict, with the
    train state under 'state' and the loop's timing under 'timing'."""
    from selftoktokenizer_tpu_torch.models.tokenizer import init_weights_
    from selftoktokenizer_tpu_torch.models.vae import SDVAE, VAEConfig
    from selftoktokenizer_tpu_torch.tools.train_tokenizer import StepClock
    from selftoktokenizer_tpu_torch.train import vae as vt
    from selftoktokenizer_tpu_torch.utils.io import walk_all_files
    from selftoktokenizer_tpu_torch.utils.logging import AverageMeter

    device = common.resolve_device(args.device)
    paths = walk_all_files(args.data_dir, common.IMAGE_EXT)
    if len(paths) <= args.holdout + args.batch_size:
        raise AssertionError(f"{len(paths)} images too few for holdout {args.holdout}")
    n_train = len(paths) - args.holdout
    common.log(f"corpus: {len(paths)} images ({n_train} train / {args.holdout} held out)")
    t0 = time.time()
    all_u8 = load_u8(paths, args.size)
    common.log(f"loaded corpus in {time.time() - t0:.1f}s")
    eval_imgs = torch.from_numpy(to_float(all_u8[n_train:n_train + args.eval_batch])).to(device)

    # SD3's GroupNorm has 32 groups: every width ch * mult must split into them
    if args.ch % 32:
        raise AssertionError(f"--ch {args.ch} must be a multiple of 32")
    cfg = VAEConfig(ch=args.ch, ch_mult=tuple(int(m) for m in args.ch_mult.split(",")),
                    num_res_blocks=args.res_blocks)
    tc = vt.VAETrainConfig(lr=args.lr, warmup_steps=args.warmup, max_steps=args.steps,
                           kl_weight=args.kl_weight, grad_norm=args.grad_norm)
    with torch.device(device):
        vae = SDVAE(cfg)
    init_weights_(vae, common.generator(device, args.seed, 0))
    n_params = sum(p.numel() for p in vae.parameters())
    common.log(f"VAE ch={args.ch} mult={cfg.ch_mult} res_blocks={cfg.num_res_blocks}: "
               f"{n_params / 1e6:.1f}M params")
    state = vt.make_vae_train_state(vae, tc)
    emit = common.metrics_writer(args.metrics_out)

    def run_eval(at_step):
        state.model.eval()
        ps, ss = vt.vae_eval_psnr(state.model, cfg, eval_imgs)
        rec = {"step": at_step, "eval_psnr_db": float(ps), "eval_ssim": float(ss)}
        common.log(f"eval @ {at_step}: held-out PSNR={rec['eval_psnr_db']:.2f} dB "
                   f"SSIM={rec['eval_ssim']:.4f}")
        emit(rec)
        return rec

    def save(step):
        os.makedirs(args.ckpt_dir, exist_ok=True)
        vt.save_vae_state(os.path.join(args.ckpt_dir, f"step_{step}"), state, cfg)

    batches = batch_indices(n_train, args.batch_size, args.seed)
    meter = AverageMeter("loss")
    pending = []
    last = {}
    run_eval(0)
    clock = StepClock(device)
    for i in range(args.steps):
        batch = to_device(to_float(all_u8[next(batches)]), device)
        with clock.step():
            state, logs = vt.vae_train_step(
                state, cfg, tc, batch, rng=common.generator(device, args.seed, NOISE_STREAM + i))
        pending.append(logs["loss"])
        last = logs
        if (i + 1) % args.log_interval == 0:
            for lv in pending:
                meter.update(float(lv))
            pending.clear()
            sps = (i + 1) / (time.perf_counter() - clock.t0)
            sc = {k: float(v) for k, v in logs.items()}
            common.log(f"step {i + 1}: loss={meter.avg:.4f} l1={sc['l1']:.4f} "
                       f"mse={sc['mse']:.4f} latent_std={sc['latent_std']:.2f} "
                       f"{sps:.2f} steps/s")
            emit({"step": i + 1, "loss_avg": meter.avg, "steps_per_s": sps, **sc})
            meter.reset()
        if (i + 1) % args.eval_interval == 0:
            run_eval(i + 1)
        if args.ckpt_interval and (i + 1) % args.ckpt_interval == 0:
            save(i + 1)
    timing = clock.summary()
    final = run_eval(args.steps) if args.steps % args.eval_interval else last
    save(args.steps)
    if args.sample_out:
        from selftoktokenizer_tpu_torch.models.vae import vae_decode, vae_encode_mode
        from selftoktokenizer_tpu_torch.pipeline.preprocess import save_image

        with torch.no_grad():
            # bf16 as the eval runs it: each fp32 weight cast at use
            x = eval_imgs[:8].to(torch.bfloat16)
            recon = vae_decode(state.model, cfg, vae_encode_mode(state.model, cfg, x)).float()
        pair = torch.cat([eval_imgs[:8], torch.clamp(recon, -1, 1)], dim=1)
        grid = torch.cat(list(pair), dim=1)       # the GT row over the recon row
        save_image((grid + 1) / 2, args.sample_out)
        common.log(f"sample pair -> {args.sample_out}")
    return {"steps": args.steps, "n_params": n_params,
            **{k: float(v) for k, v in final.items()}, "timing": timing, "state": state}


def main(argv=None):
    """Run the driver; returns the dict of ``train``."""
    res = train(build_parser().parse_args(argv))
    print(json.dumps({k: v for k, v in res.items() if k not in ("timing", "state")}),
          flush=True)
    return res


if __name__ == "__main__":
    main()
