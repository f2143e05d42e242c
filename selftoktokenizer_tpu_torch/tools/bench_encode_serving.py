"""The encode at its three precision tiers end to end, and the encoder
stage alone in its three forms (counterpart of the reference
``tools/bench_encode_serving.py``).

    python -m selftoktokenizer_tpu_torch.tools.bench_encode_serving \\
        [--batch 32] [--iters 10] [--device cuda]

The flagship config (``configs/flagship-256.yml``, or ``--yml-path``) at
256 px with seeded weights (non-zero adaLN), an encode-only pipeline,
batch 32 of images from numpy's ``default_rng(0)``, uniform in [-1, 1].

* End to end: ``SelftokPipeline.encoding(images, precision=...)`` at
  'highest' (fp32 trunk, TF32 off), 'high' (TF32 on inside the call) and
  'default' (the bf16 serving trunk).
* The encoder stage alone, on the latents of one VAE encode
  (``models/encoder.py::encoder_apply``, ``_dual_trunk``): plain fp32
  activations under the process's TF32 settings (PyTorch's default: off),
  a bf16 trunk with plain fp32-softmax scores (``fast_attn=False``), and
  the bf16 serving trunk with its query attention on the attention kernel
  (``fast_attn=True``).
* The share of ids on which the serving form and the plain form agree.

Rates: ``batch x utils.benchutil.rate_fn`` (ending in
``torch.cuda.synchronize()``). One JSON line with the card's name and
power limit.
"""

from __future__ import annotations

import argparse

import torch

from selftoktokenizer_tpu_torch.core.config import FLAGSHIP_CONFIG
from selftoktokenizer_tpu_torch.tools import common

TIERS = ("highest", "high", "default")


def stage_forms(pipe):
    """The encoder stage's three forms: name -> fn(latents) -> ids."""
    from selftoktokenizer_tpu_torch.models.encoder import encoder_apply

    enc, ecfg = pipe.encoder, pipe.tcfg.encoder
    return {
        "plain_fp32": lambda x: encoder_apply(enc, ecfg, x)[1],
        "bf16_fp32_scores": lambda x: encoder_apply(enc, ecfg, x, trunk_dtype=torch.bfloat16,
                                                    fast_attn=False)[1],
        "bf16_serving": lambda x: encoder_apply(enc, ecfg, x, trunk_dtype=torch.bfloat16,
                                                fast_attn=True)[1]}


def build_parser():
    p = argparse.ArgumentParser("bench_encode_serving")
    p.add_argument("--yml-path", default=FLAGSHIP_CONFIG)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--data_size", type=int, default=256)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="'cpu' to run on the CPU")
    return p


@torch.no_grad()
def main(argv=None):
    """Run the tool; returns the dict of its JSON line."""
    from selftoktokenizer_tpu_torch.utils.benchutil import rate_fn

    args = build_parser().parse_args(argv)
    device = common.resolve_device(args.device)
    pipe = common.seeded_pipeline(args.yml_path, device, datasize=args.data_size,
                                  encode_only=True)
    print("pipeline built", flush=True)
    B = args.batch
    images = common.uniform_images(B, args.data_size, device)

    def rate(fn):
        return B * rate_fn(fn, iters=args.iters, warm=2)

    e2e = {}
    for prec in TIERS:
        e2e[prec] = rate(lambda: pipe.encoding(images, precision=prec))
        print(f"encode end-to-end [{prec:8s}]: {e2e[prec]:8.1f} img/s", flush=True)

    x0 = pipe._images_to_latents(images)
    forms = stage_forms(pipe)
    stage = {}
    for name, fn in forms.items():
        stage[name] = rate(lambda: fn(x0))
        print(f"encoder stage {name:17s}: {stage[name]:8.1f} img/s", flush=True)
    ids_p = forms["plain_fp32"](x0)
    ids_s = forms["bf16_serving"](x0)
    agree = (ids_p == ids_s).float().mean().item()
    print(f"id agreement serving vs plain: {agree}", flush=True)
    return common.emit({
        "batch": B, "data_size": args.data_size, "card": common.card_line(device),
        "encode_images_per_s": e2e, "encoder_stage_images_per_s": stage,
        "id_agreement_serving_vs_plain": agree,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32})


if __name__ == "__main__":
    main()
