"""What the profiler's trace of the traced window says: the device's
operations, the host's operations, and the window itself.

``torch.profiler`` with CPU and CUDA activities runs over the same window
loop as the timed run; the loop is wrapped in the host annotation
``WINDOW``, whose interval bounds everything read here: device operations
that start inside it, host operations that overlap it. Times are seconds.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch

from benchmark.harness.window import gaps, union_length

WINDOW = "benchmark.window"


def _span(ev):
    if hasattr(ev, "start_ns"):
        return ev.start_ns() * 1e-9, (ev.start_ns() + ev.duration_ns()) * 1e-9
    return ev.start_us() * 1e-6, (ev.start_us() + ev.duration_us()) * 1e-6


@dataclasses.dataclass
class Trace:
    lo: float
    hi: float
    device: list        # (name, start, end): every operation on the card
    host: list          # (name, start, end): the host's operations

    @classmethod
    def from_profiler(cls, prof):
        events = prof.profiler.kineto_results.events()
        device, host, window = [], [], None
        cuda = torch.autograd.DeviceType.CUDA
        for ev in events:
            name = ev.name()
            if ev.device_type() == cuda:
                if getattr(ev, "is_user_annotation", lambda: False)() or name == WINDOW:
                    continue
                device.append((name, *_span(ev)))
            elif name == WINDOW:
                window = _span(ev)
            else:
                host.append((name, *_span(ev)))
        if window is None:
            raise RuntimeError(f"the trace holds no '{WINDOW}' annotation")
        lo, hi = window
        return cls(lo, hi, [d for d in device if lo <= d[1] < hi],
                   [h for h in host if h[1] < hi and h[2] > lo])

    @property
    def window_s(self):
        return self.hi - self.lo

    def busy_s(self):
        """Seconds of the window in which some operation ran on the card."""
        return union_length([(s, e) for _, s, e in self.device], self.lo, self.hi)

    def kernels(self):
        """The device operations that are kernels (no copies or fills)."""
        return [d for d in self.device if not d[0].startswith(("Memcpy", "Memset"))]

    def matching(self, patterns):
        """(count, seconds) of the kernels whose name matches any of the
        regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        hits = [(s, e) for n, s, e in self.kernels() if any(r.search(n) for r in rx)]
        return len(hits), sum(e - s for s, e in hits)

    def top_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time."""
        by = {}
        for name, s, e in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """[[what the host was doing, seconds]] of the longest stretches in
        which the card ran nothing: the innermost host operation running at
        the gap's start."""
        idle = sorted(gaps([(s, e) for _, s, e in self.device], self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:n]
        if not self.host:
            return [["(no host operation)", e - s] for s, e in idle]
        names = [h[0] for h in self.host]
        hs = np.array([h[1] for h in self.host])
        he = np.array([h[2] for h in self.host])
        out = []
        for s, e in idle:
            live = np.nonzero((hs <= s) & (he > s))[0]
            if len(live):
                name = names[live[np.argmin(he[live] - hs[live])]]
            else:
                name = "(no host operation)"
            out.append([name, e - s])
        return out
