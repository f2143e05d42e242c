"""Summarize a training run's metrics file (``train_tokenizer
--metrics-out``) into a table (counterpart of the reference
``tools/summarize_convergence.py``): loss, diffusion MSE, VQ perplexity and
commitment, and the held-out eval's latent MSE and SNR at the eval steps
and the last step; then the reactivation and stability counters.

    python -m selftoktokenizer_tpu_torch.tools.summarize_convergence metrics.jsonl

Numpy only; prints the text.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def main(path):
    train, evals = [], []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            (evals if "eval_latent_mse" in rec else train).append(rec)
    train.sort(key=lambda r: r["step"])
    evals.sort(key=lambda r: r["step"])

    def at(step):
        cand = [r for r in train if r["step"] <= step]
        return cand[-1] if cand else None

    nan = float("nan")
    steps = sorted({r["step"] for r in evals} | {train[-1]["step"]})
    print(f"{'step':>6} {'loss':>8} {'dm_mse':>8} {'perplex':>8} "
          f"{'commit':>9} {'eval_mse':>9} {'snr_dB':>7}")
    ev_by_step = {r["step"]: r for r in evals}
    for s in steps:
        t = at(s)
        e = ev_by_step.get(s, {})
        print(f"{s:>6} "
              f"{t['loss_avg'] if t else nan:>8.4f} "
              f"{t['dm_mse'] if t else nan:>8.4f} "
              f"{t['vq_perplexity'] if t else nan:>8.1f} "
              f"{t['vq_commit_loss'] if t else nan:>9.5f} "
              f"{e.get('eval_latent_mse', nan):>9.4f} "
              f"{e.get('eval_latent_snr_db', nan):>7.2f}")

    dm = np.array([r["dm_mse"] for r in train])
    ppl = np.array([r["vq_perplexity"] for r in train])
    reacts = np.array([r.get("vq_n_reactive", 0) for r in train])
    finite = all(np.isfinite(v) for r in train for v in r.values() if isinstance(v, float))
    print(f"\nsteps logged: {len(train)} (to {train[-1]['step']}), all finite: {finite}")
    print(f"dm_mse: first-5 {dm[:5].mean():.4f} -> last-5 {dm[-5:].mean():.4f}"
          f" ({dm[-5:].mean() / dm[:5].mean():.2%})")
    print(f"perplexity: first {ppl[0]:.1f} -> max {ppl.max():.1f} -> last {ppl[-1]:.1f}")
    print(f"react events: {int((reacts > 0).sum())} log intervals, "
          f"total {int(reacts.sum())} codes")
    if len(evals) >= 2:
        print(f"eval latent mse: {evals[0]['eval_latent_mse']:.4f} -> "
              f"{evals[-1]['eval_latent_mse']:.4f}; snr "
              f"{evals[0]['eval_latent_snr_db']:.2f} -> "
              f"{evals[-1]['eval_latent_snr_db']:.2f} dB")


if __name__ == "__main__":
    main(sys.argv[1])
