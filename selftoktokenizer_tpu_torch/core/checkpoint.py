"""Checkpoint I/O on ``torch.save`` / ``torch.load`` (counterpart of the
reference ``core/checkpoint.py``, whose Orbax calls have no place here), the
reference's partial loader and the EMA update.

A checkpoint is one file holding a nested dict of tensors and plain Python
values (a train state: parameters, optimizer state, VQ state, step). It is
written to a temporary file beside the target and renamed, so a run killed
while saving leaves the previous checkpoint whole.
"""

from __future__ import annotations

import os

import torch


def save_checkpoint(path, tree):
    """Write ``tree`` (nested dicts / lists of tensors and plain values)."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path):
    """Read a ``save_checkpoint`` file onto the CPU."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)


def partial_merge(params, incoming, drop_mismatched=True, log=None):
    """Merge the ``incoming`` {name: tensor} entries into a copy of the
    ``params`` {name: tensor} dict, skipping names ``params`` lacks and,
    with drop_mismatched, entries of another shape (the reference's
    ``load_state(strict=False)``). ``log`` is told the unexpected, dropped
    and not-covered names."""
    merged = dict(params)
    unexpected, mismatched = [], []
    for k, v in incoming.items():
        if k not in params:
            unexpected.append(k)
            continue
        if tuple(v.shape) != tuple(params[k].shape):
            mismatched.append(k)
            if drop_mismatched:
                continue
        merged[k] = v
    if log:
        if unexpected:
            log(f"unexpected keys: {unexpected}")
        if mismatched:
            log(f"shape-mismatched (dropped): {mismatched}")
        not_loaded = [k for k in params if k not in incoming]
        if not_loaded and incoming:
            log(f"params not in checkpoint (keep init): {len(not_loaded)} "
                f"leaves, e.g. {not_loaded[:5]}")
    return merged


@torch.no_grad()
def ema_update(ema, params, decay=0.9999):
    """ema <- decay*ema + (1-decay)*params, in place, over the names of the
    ``ema`` dict; params: {name: tensor}."""
    for k, e in ema.items():
        e.copy_(decay * e + (1 - decay) * params[k].detach())
    return ema
