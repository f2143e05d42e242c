"""Precision-tier certification on a trained tokenizer checkpoint
(counterpart of the reference ``tools/certify_tiers.py``).

For each encode tier ('highest', 'high', 'default'), against the ids of
'highest':

* the id flip rate over a latent corpus, with the VQ top-2 margin statistics
  (overall and at the flipped positions) and the code cosine of flipped
  pairs;
* the latent MSE of a ``--decode-steps`` diffusion decode of a held-out
  batch from each tier's ids, the decode's numerics held fixed (fp32, TF32
  off) so that only the ids differ.

    python -m selftoktokenizer_tpu_torch.tools.certify_tiers --ckpt ckpt/step_20000 \\
        --yml-path configs/conv-small.yml --latents-file lat.npy \\
        [--n 1024] [--eval-batch 32] [--ema] [--out tiers.jsonl] [--device cuda]

The tiers are the pipeline's encode paths (``pipeline.encode_latents``):
'default' is the dual encoder's bf16 serving trunk with its query
attention on the attention kernel, 'high' the fp32 trunk with TF32 on,
'highest' with TF32 off; every tier's ids come from ``vq_argmax`` on a
CUDA device, and its margins from the exact fp32 scores of the same trunk.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from selftoktokenizer_tpu_torch.tools import common

TIERS = ("highest", "high", "default")
DECODE_NOISE = 424242


def build_parser():
    p = argparse.ArgumentParser("certify_tiers")
    p.add_argument("--ckpt", required=True, help="save_train_state file (step_N)")
    p.add_argument("--yml-path", required=True)
    p.add_argument("--latents-file", required=True)
    p.add_argument("--n", type=int, default=1024, help="corpus rows for flip / margin statistics")
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--eval-batch", type=int, default=32,
                   help="held-out rows (taken from the END) for the decode MSE")
    p.add_argument("--decode-steps", type=int, default=25)
    p.add_argument("--ema", action="store_true", help="certify the EMA weights, not the raw ones")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


def load_tokenizer(path, tcfg, ema, device):
    """(ImageTokenizer on device with a train state file's live or EMA
    weights, frozen; the file's contents)."""
    from selftoktokenizer_tpu_torch.core.checkpoint import restore_checkpoint
    from selftoktokenizer_tpu_torch.models.tokenizer import ImageTokenizer

    raw = restore_checkpoint(path)
    if ema and raw.get("ema_params") is None:
        raise AssertionError(f"{path} has no ema_params")
    sd = dict(raw["params"])
    if ema:
        sd.update(raw["ema_params"])
    with torch.device("meta"):
        tok = ImageTokenizer(tcfg)
    tok.load_state_dict(sd, strict=True, assign=True)
    return tok.to(device).requires_grad_(False), raw


@torch.no_grad()
def decode_mse(tok, tcfg, ids, x0, steps, noise):
    """Latent MSE of the ``steps``-step decode from ids, fp32 with TF32 off."""
    from selftoktokenizer_tpu_torch.models import vq as vq_mod
    from selftoktokenizer_tpu_torch.ops.norms import layer_norm
    from selftoktokenizer_tpu_torch.ops.precision import fp32_exact
    from selftoktokenizer_tpu_torch.tools.train_tokenizer import decode_sampler, diffusion_decode

    enc = tok.encoder
    sched, step_k = decode_sampler(tcfg, steps)
    with fp32_exact(True):
        ctx = vq_mod.get_output_from_indices(enc.quantizer, ids)
        if tcfg.encoder.post_norm:
            ctx = layer_norm(ctx, enc.final_layer_norm3.weight, enc.final_layer_norm3.bias)
        pred = diffusion_decode(tok, tcfg, ctx, noise, sched, step_k, tcfg.context_see_xt)
        return float(torch.mean((pred - x0) ** 2))


@torch.no_grad()
def tier_ids(tok, tcfg, x, tier):
    """(ids, margins) of one batch of latents at one tier, as numpy."""
    from selftoktokenizer_tpu_torch.pipeline.pipeline import encode_latents

    _, ids = encode_latents(tok.encoder, tcfg.encoder, x, tier)
    _, margins = encode_latents(tok.encoder, tcfg.encoder, x, tier, margins=True)
    return ids.cpu().numpy(), margins.float().cpu().numpy()


def certify(tok, tcfg, lat, n, batch, eval_batch, decode_steps, device, noise=None,
            meta=None):
    """The records of the three tiers. lat: the latents (array or memory
    map); the statistics take its first min(n, N - eval_batch) rows, the
    decode its last eval_batch. noise: the decode's start noise (drawn from
    generator(device, 424242) when None). meta: entries every record
    carries."""
    n_stat = min(n, lat.shape[0] - eval_batch)
    eval_x = torch.from_numpy(np.array(lat[lat.shape[0] - eval_batch:], np.float32)).to(device)
    if noise is None:
        noise = torch.randn(eval_x.shape, generator=common.generator(device, DECODE_NOISE),
                            device=device)
    noise = torch.as_tensor(noise).to(device)
    ids_all, marg_all, eval_ids = {}, {}, {}
    for tier in TIERS:
        parts = [tier_ids(tok, tcfg, torch.from_numpy(np.array(lat[i:i + batch], np.float32))
                          .to(device), tier) for i in range(0, n_stat, batch)]
        ids_all[tier] = np.concatenate([p[0] for p in parts])
        marg_all[tier] = np.concatenate([p[1] for p in parts])
        eval_ids[tier] = tier_ids(tok, tcfg, eval_x, tier)[0]

    embed = tok.encoder.quantizer.embed.detach().float().cpu().numpy()
    embed = embed / (np.linalg.norm(embed, axis=-1, keepdims=True) + 1e-12)
    ref_ids = ids_all["highest"]
    records = []
    for tier in TIERS:
        ids, m = ids_all[tier], marg_all[tier]
        flips = ids != ref_ids
        rec = {"tier": tier, **(meta or {}),
               "n_tokens": int(ids.size),
               "flip_rate_vs_highest": float(flips.mean()),
               "margin_median": float(np.median(m)),
               "margin_p1": float(np.percentile(m, 1)),
               "frac_margin_lt_1e2": float((m < 1e-2).mean()),
               "decode_mse": decode_mse(tok, tcfg, torch.from_numpy(eval_ids[tier]).to(device),
                                        eval_x, decode_steps, noise),
               "eval_flip_rate": float((eval_ids[tier] != eval_ids["highest"]).mean())}
        if flips.any():
            cos = np.einsum("nd,nd->n", embed[ids[flips]], embed[ref_ids[flips]])
            rec["flip_margin_median"] = float(np.median(marg_all["highest"][flips]))
            rec["flip_code_cosine_median"] = float(np.median(cos))
            rec["flip_code_cosine_min"] = float(cos.min())
        records.append(rec)
        common.log(json.dumps(rec))
    return records


def main(argv=None):
    """Run the tool; returns its records."""
    from selftoktokenizer_tpu_torch.core.config import load_config
    from selftoktokenizer_tpu_torch.models.tokenizer import tokenizer_config_from_params

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    tcfg = tokenizer_config_from_params(dict(load_config(args.yml_path).tokenizer.params))
    tok, raw = load_tokenizer(args.ckpt, tcfg, args.ema, device)
    common.log(f"{'EMA' if args.ema else 'raw'} params from {args.ckpt} (step {raw.get('step')})")
    lat = np.load(args.latents_file, mmap_mode="r")
    common.log(f"latents {lat.shape}: {min(args.n, lat.shape[0] - args.eval_batch)} stat rows, "
               f"{args.eval_batch} held-out decode rows")
    meta = {"ckpt": args.ckpt, "step": int(raw.get("step", -1)), "ema": bool(args.ema)}
    records = certify(tok, tcfg, lat, args.n, args.batch, args.eval_batch, args.decode_steps,
                      device, meta=meta)
    if args.out:
        with open(args.out, "a") as f:
            for rec in records:
                f.write(json.dumps(rec) + "\n")
    return records


if __name__ == "__main__":
    main()
