"""Run one cell of the benchmark and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, the port's
package and ``benchmark/``. The cell's files (``harness/spec.py``) say what
runs: set-up builds the program with seeded weights and the traffic's pool
and warms every shape the traffic uses (the first run in a checkout also
builds the port's kernels); then one closed-loop caller makes back-to-back
calls for ``--seconds``. With ``--trace 1`` a further window of the cell's
``trace_calls`` calls runs under ``torch.profiler``, after one call that
takes the profiler's start-up. Once the windows have
closed and the program's state is freed, the plain reference recomputes a
sample of the answers and each compared number is held to the cell's limit.

The last line of standard output is the result; the last lines of standard
error are the compared numbers beside their limits. Without a CUDA device
(or with fewer than the cell asks for), or with JAX or the JAX package
loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()       # set-up is counted from here

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# every kernel and build cache of this process at a fixed path in the checkout
_CACHE = os.path.join(_ROOT, "benchmark", ".cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(_CACHE, "inductor")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")

import torch  # noqa: E402

from benchmark.harness import spec, trace as trace_mod, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "selftoktokenizer_tpu")


@dataclasses.dataclass
class RunData:
    """What a metric's reader reads."""
    cell: object
    images_per_call: int
    setup_s: float
    window: window.Window           # the timed window
    peak_bytes: int                 # max_memory_allocated over the timed window
    work: dict                      # the driver's accounting of one call, or None
    trace: object = None            # trace.Trace of the traced window
    traced_calls: int = 0
    sm_clock_hz: float = None


def forbidden_modules():
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sm_clock_hz():
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def run_cell(cell, seed, seconds, trace=False, device="cuda", t0=None, overrides=None,
             patch=None, calls=None, root=spec.ROOT):
    """Run ``cell`` and return (result dict, RunData). ``overrides``
    replaces driver options (the control's lower precision); ``patch(driver)``
    runs once set-up has built the driver (the tests' planted faults);
    ``calls`` makes the timed window that many calls instead."""
    t0 = T0 if t0 is None else t0
    cuda = device != "cpu"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    drv = spec.driver_class(cell.options["driver"])(cell, seed, device, overrides)
    if patch is not None:
        patch(drv)
    drv.warm()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    win = (window.run(drv.call, sync, seconds) if calls is None
           else window.run(drv.call, sync, float("inf"), max_calls=calls))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    data = RunData(cell=cell, images_per_call=drv.images_per_call, setup_s=setup_s,
                   window=win, peak_bytes=peak, work=drv.work())
    if trace:
        n = cell.options["trace_calls"]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            # one call first takes the profiler's own start-up; the trace is
            # read inside the annotated window only
            drv.call(win.calls)
            sync()
            with torch.profiler.record_function(trace_mod.WINDOW):
                window.run(lambda i: drv.call(win.calls + 1 + i), sync, float("inf"),
                           max_calls=n)
        data.trace = trace_mod.Trace.from_profiler(prof)
        data.traced_calls = n
        data.sm_clock_hz = sm_clock_hz() if cuda else None
        del prof
    drv.release()
    gc.collect()
    numbers, info = drv.check()
    limits = cell.options["limits"]
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"cells/{cell.name}.json has no limit for {missing}")
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"], root)(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win.calls, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace:
        dev["busy_s"] = data.trace.busy_s()
        dev["window_s"] = data.trace.window_s
        result["breakdown"] = {"device_ops": data.trace.top_ops(10),
                               "idle_gaps": data.trace.idle_gaps(10)}
    c = sorted(win.call_s)
    result["info"] = dict(info, call_s_min_median_max=[c[0], c[len(c) // 2], c[-1]])
    result["checks"] = checks
    return result, data


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result, _ = run_cell(cell, args.seed, args.seconds, trace=bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark runs without them",
              file=sys.stderr)
        return 3
    for k, v in result["info"].items():
        print(f"info {k} {v}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
