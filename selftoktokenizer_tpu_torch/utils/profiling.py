"""Profiling and tracing (counterpart of the reference
``utils/profiling.py``): a ``torch.profiler`` trace of a block, named
regions on its timeline, and a steady-state step timer."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir="selftok_trace", record_shapes=False):
    """Trace the host and, when CUDA is there, the device around a block:

        with trace("out/trace") as prof:
            step()

    Writes a Chrome / Perfetto trace into ``log_dir``
    (``trace_<pid>_<n>.json``); yields the profiler, whose
    ``key_averages()`` sums the time by operator and kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=record_shapes) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    n = len([f for f in os.listdir(log_dir) if f.startswith(f"trace_{os.getpid()}_")])
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


def annotate(name):
    """A named region on the trace's timeline (``record_function``)."""
    from torch.profiler import record_function

    return record_function(name)


def _sync(out):
    """Wait for the devices of out's tensors (nested tuples, lists, dicts)."""
    devices = set()

    def walk(x):
        if torch.is_tensor(x):
            devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def step_timer(fn, *args, iters=10, warmup=2):
    """Steady-state seconds a call of fn(*args): ``warmup`` calls, then
    ``iters`` timed ones, each end synchronised on the devices of the
    output's tensors."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters
