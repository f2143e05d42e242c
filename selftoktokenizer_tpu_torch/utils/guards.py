"""Failure detection for long training runs (counterpart of the reference
``utils/guards.py``): catch a NaN / Inf divergence early and keep the last
good state, so the caller can roll back."""

from __future__ import annotations

import math

import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def tree_finite(tree):
    """A bool scalar tensor: every floating tensor of ``tree`` (a tensor, a
    state dict, or nested dicts, lists and tuples of them) is all finite.
    Integer and bool leaves, and anything not a tensor, are not checked.
    It stays on the device of the tensors (no host sync until read)."""
    flags = [torch.all(torch.isfinite(t.detach())) for t in _tensors(tree)
             if t.is_floating_point() or t.is_complex()]
    if not flags:
        return torch.tensor(True)
    dev = flags[0].device
    return torch.all(torch.stack([f.to(dev) for f in flags]))


class DivergenceGuard:
    """Host-side guard around a train loop:

        guard = DivergenceGuard(patience=3)
        for step:
            state, logs = step_fn(...)
            guard.check(float(logs['loss']), state)   # raises on divergence

    A step is bad when its loss is not finite or is above ``loss_ceiling``;
    ``patience`` bad steps in a row raise ``FloatingPointError``. A good step
    resets the streak and keeps its state as ``last_good``."""

    def __init__(self, patience=1, loss_ceiling=None):
        self.patience = patience
        self.loss_ceiling = loss_ceiling
        self.bad_streak = 0
        self.last_good = None

    def check(self, loss, state=None):
        """Returns whether the step was good."""
        bad = not math.isfinite(loss)
        if self.loss_ceiling is not None and loss > self.loss_ceiling:
            bad = True
        if bad:
            self.bad_streak += 1
            if self.bad_streak >= self.patience:
                raise FloatingPointError(
                    f"training diverged: loss={loss} for "
                    f"{self.bad_streak} consecutive steps")
        else:
            self.bad_streak = 0
            if state is not None:
                self.last_good = state
        return not bad
