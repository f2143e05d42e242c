"""The measured window and the arithmetic of its end-to-end numbers."""

from __future__ import annotations

import dataclasses
import math
import time


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float          # first call's start to the last call's end
    call_s: list            # each call's wall time, ending in a synchronize


def run(call, sync, seconds, max_calls=None):
    """Back-to-back calls ``call(i)``, each ended by ``sync()``, from one
    closed-loop caller. A call starts only while less than ``seconds`` have
    passed, and the window ends when that call has finished; ``max_calls``
    ends it earlier."""
    times = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        call(len(times))
        sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if t1 - start >= seconds or (max_calls is not None and len(times) >= max_calls):
            return Window(calls=len(times), seconds=t1 - start, call_s=times)


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union_length(intervals, lo, hi):
    """Length of the union of [start, end) intervals, clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle stretches [start, end) of [lo, hi) that no interval covers."""
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]
