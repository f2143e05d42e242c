"""The renderer's training driver (counterpart of the reference
``tools/train_renderer.py``): the one-step ``MMDiT_XL_Renderer`` learns to
reconstruct latents from the tokens of a FROZEN trained tokenizer
(``renderer-eval.yml``'s ``pretrain_model`` and ``train_filter``); the
reconstruction MSE is its loss.

    python -m selftoktokenizer_tpu_torch.tools.train_renderer \\
        --yml-path configs/conv-small-renderer.yml --tokenizer-ckpt ckpt/step_20000 \\
        --latents-file lat.npy --steps 4000 [--metrics-out m.jsonl --eval-interval 500] \\
        [--device cuda]

``--tokenizer-ckpt`` is a ``save_train_state`` file (its encoder, and its VQ
state, which the renderer's checkpoints carry on so that their export is a
whole reference state dict) or a reference-named ``.pth`` / ``.pt`` /
``.safetensors`` (the ``encoder.*`` entries; no VQ state). Each pass over
the latents file permutes its training rows by
``default_rng((data_seed, pass))``; the last ``--eval-batch`` rows are held
out when ``--eval-interval`` is set. A checkpoint holds ``params`` (the
frozen ``encoder.*`` and the trained ``model.*``, the names of an
``ImageTokenizer`` of the renderer config), ``ema_params`` (the same with
the EMA copy of the model), ``vq_state`` and ``step``; it goes through
``convert_ckpt export``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from selftoktokenizer_tpu_torch.tools import common

MODEL_SEED_LABEL = 2


def build_parser():
    p = argparse.ArgumentParser("train_renderer")
    p.add_argument("--yml-path", default="configs/conv-small-renderer.yml")
    p.add_argument("--tokenizer-ckpt", required=True,
                   help="save_train_state file or reference-named .pth / .pt / "
                        ".safetensors supplying the frozen encoder (renderer-eval.yml "
                        "pretrain_model)")
    p.add_argument("--latents-file", required=True)
    p.add_argument("--steps", type=int, default=4000)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--dit-lr", type=float, default=1e-4)
    p.add_argument("--grad-norm", type=float, default=1.0)
    p.add_argument("--ema-decay", type=float, default=0.0)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--data-seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--eval-interval", type=int, default=0)
    p.add_argument("--eval-batch", type=int, default=32)
    p.add_argument("--eval-image-space", action="store_true",
                   help="VAE-decode the held-out one-step recons and report image PSNR / "
                        "SSIM against the corpus images (a --latents-file with an "
                        "encode_corpus .meta.json sidecar); saves GT / recon PNG pairs at "
                        "step 0 and at the last eval")
    p.add_argument("--lr-schedule", default="constant",
                   choices=["constant", "cosine", "linear"])
    p.add_argument("--end-lr-ratio", type=float, default=0.1)
    p.add_argument("--ckpt-interval", type=int, default=0)
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "renderer_ckpt"))
    p.add_argument("--metrics-out", default=None)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def load_frozen_encoder(path, tcfg, device):
    """(encoder module on device, frozen; the VQ state as a dict of CPU
    tensors or None) of a save_train_state file or a reference-named state
    dict file."""
    from selftoktokenizer_tpu_torch.core.checkpoint import restore_checkpoint
    from selftoktokenizer_tpu_torch.models.encoder import QformerEncoder
    from selftoktokenizer_tpu_torch.utils.io import load_state_dict_file

    if path.endswith((".pth", ".pt", ".safetensors")):
        sd, vq_state = load_state_dict_file(path), None
        sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    else:
        raw = restore_checkpoint(path)
        sd, vq_state = raw["params"], raw.get("vq_state")
    enc_sd = {k[len("encoder."):]: v for k, v in sd.items() if k.startswith("encoder.")}
    with torch.device("meta"):
        enc = QformerEncoder(tcfg.encoder)
    own = set(enc.state_dict())
    # a reference file also holds the quantizer's EMA buffers, which are
    # no weights of the module
    enc.load_state_dict({k: v.float() if v.is_floating_point() else v
                         for k, v in enc_sd.items() if k in own}, strict=True, assign=True)
    return enc.to(device).requires_grad_(False), vq_state


def train(args):
    """The training loop. Returns the final JSON line's dict, with the
    train state under 'state' and the loop's timing under 'timing'."""
    from selftoktokenizer_tpu_torch.core.checkpoint import save_checkpoint
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.models.encoder import encoder_apply
    from selftoktokenizer_tpu_torch.models.mmdit import MMDiT, renderer_apply
    from selftoktokenizer_tpu_torch.models.tokenizer import (
        init_weights_, tokenizer_config_from_params)
    from selftoktokenizer_tpu_torch.tools.train_tokenizer import (
        StepClock, image_eval, save_pair, swapped_weights)
    from selftoktokenizer_tpu_torch.train import trainer

    device = common.resolve_device(args.device)
    cfg = load_config(args.yml_path)
    tcfg = tokenizer_config_from_params(dict(cfg.tokenizer.params))
    if not tcfg.decoder.renderer:
        raise AssertionError(f"{args.yml_path} is not a renderer config")
    seed = cfg.common.get("random_seed", 123)

    encoder, vq_state = load_frozen_encoder(args.tokenizer_ckpt, tcfg, device)
    common.log(f"frozen tokenizer from {args.tokenizer_ckpt}")
    with torch.device(device):
        model = MMDiT(tcfg.decoder)
    init_weights_(model, common.generator(device, seed, MODEL_SEED_LABEL))
    tc = trainer.TrainConfig(dit_lr=args.dit_lr, warmup_steps=args.warmup,
                             grad_norm=args.grad_norm, ema_decay=args.ema_decay,
                             schedule=args.lr_schedule, end_lr_ratio=args.end_lr_ratio,
                             max_steps=args.steps)
    state = trainer.make_renderer_train_state(model, tc)

    lat = np.load(args.latents_file, mmap_mode="r")
    n_eval = args.eval_batch if args.eval_interval else 0
    n_train = lat.shape[0] - n_eval
    eval_x = torch.from_numpy(np.array(lat[n_train:], np.float32)).to(device) if n_eval else None
    common.log(f"latents {lat.shape}: {n_train} train / {n_eval} eval")

    @torch.no_grad()
    def eval_once(x):
        d = torch.full((x.shape[0],), tcfg.k - 1, dtype=torch.int32, device=device)
        ehs, _, _, mask, _, _, _ = encoder_apply(encoder, tcfg.encoder, x, d=d)
        pred = renderer_apply(state.model, tcfg.decoder, ehs, mask=mask)
        return torch.mean((pred - x) ** 2), pred

    score = gt = None
    if args.eval_image_space:
        if not args.eval_interval:
            raise AssertionError("--eval-image-space needs --eval-interval")
        score, gt = image_eval(args.latents_file + ".meta.json",
                               slice(n_train, n_train + n_eval), device)
    emit = common.metrics_writer(args.metrics_out)

    def run_eval(at):
        tracks = [("", None)]
        if state.ema_params is not None:
            tracks.append(("_ema", state.ema_params))
        rec = {"step": at}
        for tag, params in tracks:
            with swapped_weights(state.model, params) if params else contextlib.nullcontext():
                mse, pred = eval_once(eval_x)
            rec[f"eval_recon_mse{tag}"] = float(mse)
            msg = f"eval{tag} @ {at}: held-out recon mse={float(mse):.4f}"
            if score is not None:
                ps, ss, img = score(pred)
                rec[f"eval_image_psnr_db{tag}"] = float(ps)
                rec[f"eval_image_ssim{tag}"] = float(ss)
                msg += f" | image PSNR={float(ps):.2f} dB SSIM={float(ss):.4f}"
                if tag == "" and at in (0, args.steps):
                    os.makedirs(args.ckpt_dir, exist_ok=True)
                    out = os.path.join(args.ckpt_dir, f"imgrecon_{at}.png")
                    save_pair(gt, img, out)
                    common.log(f"GT/recon pair -> {out}")
            common.log(msg)
        emit(rec)

    def save(step):
        enc_sd = {"encoder." + k: v for k, v in encoder.state_dict().items()}
        tree = {"params": {**enc_sd, **{"model." + k: v for k, v in
                                        state.model.state_dict().items()}},
                "step": state.step}
        if state.ema_params is not None:
            # the same names as params: the export reads either
            tree["ema_params"] = {**enc_sd, **{"model." + k: v for k, v in
                                               state.ema_params.items()}}
        if vq_state is not None:
            tree["vq_state"] = dict(vq_state)
        os.makedirs(args.ckpt_dir, exist_ok=True)
        save_checkpoint(os.path.join(args.ckpt_dir, f"step_{step}"), tree)

    if args.steps <= 0:
        raise AssertionError("--steps must be positive")
    B = args.batch_size
    if n_train < B:
        raise AssertionError(f"{n_train} training latents < batch {B}")
    logs = None
    if args.eval_interval:
        run_eval(0)
    clock = StepClock(device)
    i = epoch = 0
    while i < args.steps:
        order = np.random.default_rng((args.data_seed, epoch)).permutation(n_train)
        for s in range(0, n_train - B + 1, B):
            if i >= args.steps:
                break
            batch = torch.from_numpy(np.asarray(lat[np.sort(order[s:s + B])], np.float32))
            batch = batch.to(device)
            with clock.step():
                state, logs = trainer.renderer_train_step(state, tcfg, tc, encoder, batch)
            i += 1
            if i % args.log_interval == 0:
                sps = i / (time.perf_counter() - clock.t0)
                sc = {k: float(v) for k, v in logs.items()}
                common.log(f"step {i}: recon_mse={sc['recon_mse']:.4f} "
                           f"ppl={sc['batch_perplexity']:.0f} {sps:.2f} steps/s")
                emit({"step": i, "epoch": epoch, "steps_per_s": sps, **sc})
            if args.eval_interval and i % args.eval_interval == 0:
                run_eval(i)
            if args.ckpt_interval and i % args.ckpt_interval == 0:
                save(i)
        epoch += 1
    return {"final_recon_mse": float(logs["recon_mse"]), "steps": args.steps,
            "timing": clock.summary(), "state": state, "encoder": encoder}


def main(argv=None):
    """Run the driver; returns the dict of ``train``."""
    res = train(build_parser().parse_args(argv))
    print(json.dumps({"final_recon_mse": res["final_recon_mse"], "steps": res["steps"]}),
          flush=True)
    return res


if __name__ == "__main__":
    main()
