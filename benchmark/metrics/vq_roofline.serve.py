"""The VQ argmax kernel's share of its roofline over the traced window: the
least time of the traced calls' argmaxes (``yardstick.vq_bound``) over the
device time of the kernels whose names match ``PATTERNS``, in %. Reads
nothing where no kernel matches."""

from benchmark.harness.yardstick import vq_bound

PATTERNS = [r"vq_argmax_kernel"]


def read(run):
    if run.trace is None or not run.work or "vq" not in run.work or not run.sm_clock_hz:
        return None
    n, seconds = run.trace.matching(PATTERNS)
    if n == 0 or seconds <= 0:
        return None
    return 100.0 * vq_bound(*run.work["vq"], run.sm_clock_hz) * run.traced_calls / seconds
