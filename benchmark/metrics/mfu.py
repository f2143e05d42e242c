"""The step's share of the card's peak: the model FLOPs of the timed
window's calls, each precision class at its own peak (``yardstick.PEAKS``;
fp32-exact work at the split-TF32 peak), as the least time the card needs,
over the window's wall time, in %. The driver's ``work()`` counts a call:
a serving call's forward, or a training step at three times its forward.
Read for ``mfu.serve`` and ``mfu.train``."""

from benchmark.harness.yardstick import least_time


def read(run):
    if not run.work:
        return None
    return 100.0 * least_time(run.work["flops"]) * run.window.calls / run.window.seconds
