"""Faults planted in a training step, each a ``patch`` of the train driver
(``run.run_cell(..., patch=)``): for the tests at a tiny size, and for the
readings on the card at the cell's own (``tools/calibrate.py --fault``)."""

from __future__ import annotations

import torch


def train_faults():
    """The faults of a training step, each a ``patch`` of the train driver:
    the step leaves the state unchanged (forward and backward, no update);
    half the batch left out (the loss a mean over the rest); one element of
    the updated parameters altered where the step produces them."""
    def unchanged(drv):
        from selftoktokenizer_tpu_torch.train import trainer

        def step(state, tcfg, tc, x, **d):
            loss, aux, _ = trainer.tokenizer_grads(state, tcfg, x, **d)
            return state, {"loss": loss.detach()}
        drv._train_step = step

    def half(drv):
        orig = drv._train_step

        def step(state, tcfg, tc, x, **d):
            n = x.shape[0] // 2
            d = {k: v[:n] if k in ("t", "drop_ids", "noise") else v for k, v in d.items()}
            d["kmeans_idx"] = d["kmeans_idx"] % (n * drv.cfg["K"])
            return orig(state, tcfg, tc, x[:n], **d)
        drv._train_step = step

    def altered(drv):
        orig = drv._train_step

        def step(state, tcfg, tc, x, **d):
            state, logs = orig(state, tcfg, tc, x, **d)
            with torch.no_grad():
                w = state.model.encoder.blocks[0].attn.qkv.weight
                w[0, 0] += 0.1 * w.abs().max()
            return state, logs
        drv._train_step = step

    return {"unchanged": unchanged, "half": half, "altered": altered}
