"""The bf16 attention kernel's share of its roofline over the traced
window: the least time of the attention calls the traced calls make (both
products over each row's active keys at the bf16 peak, or the bytes), over
the device time of the kernels whose names match ``PATTERNS``, in %. Reads
nothing where no kernel matches."""

from benchmark.harness.yardstick import attention_bound

PATTERNS = [r"flash_bf16_kernel"]


def read(run):
    if run.trace is None or not run.work or not run.work.get("attention"):
        return None
    n, seconds = run.trace.matching(PATTERNS)
    if n == 0 or seconds <= 0:
        return None
    bound = sum(attention_bound(*a) for a in run.work["attention"]) * run.traced_calls
    return 100.0 * bound / seconds
