"""Meters, registry and timing helpers (counterpart of the reference
``utils/logging.py``): ``AverageMeter``, ``Timer``, ``Registry``,
``time_since`` and ``rank_zero_only`` on ``torch.distributed``'s rank.

A meter accumulates locally; a multi-rank caller sums its ``sum`` and
``count`` over the ranks itself (``tools/eval_recon.py`` all-reduces them).
"""

from __future__ import annotations

import math
import time

from selftoktokenizer_tpu_torch.parallel.distributed import rank_and_world


def rank_zero_only(fn):
    """Run ``fn`` on rank 0 of the default group only (every call outside a
    group); the other ranks get None."""

    def wrapped(*a, **k):
        if rank_and_world()[0] == 0:
            return fn(*a, **k)
    return wrapped


class Registry(dict):
    """Name -> constructor registry."""

    def __init__(self, name):
        super().__init__()
        self._name = name

    def register(self, fn=None, name=None):
        def deco(f):
            key = name or f.__name__
            if key in self:
                raise KeyError(f"{key} already registered in {self._name}")
            self[key] = f
            return f
        return deco(fn) if fn is not None else deco

    def get(self, key):
        if key not in self:
            raise KeyError(f"{key} not found in registry {self._name}")
        return self[key]


def time_since(since):
    s = time.time() - since
    m = math.floor(s / 60)
    return f"{m}m {s - m * 60:.0f}s"


class Timer:
    """Stopwatch, also a context manager (``duration`` after the block)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._start = time.time()

    def elapsed(self):
        return time.time() - self._start

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *exc):
        self.duration = self.elapsed()


class AverageMeter:
    """Running average: ``update(value, n)`` adds value * n to ``sum`` and n
    to ``count``."""

    def __init__(self, name=""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)

    def __str__(self):
        return f"{self.name} {self.val:.4f} ({self.avg:.4f})"
