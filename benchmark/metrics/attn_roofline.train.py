"""The fp32 attention kernels' share of their roofline over the traced
steps: the least time of the steps' attention forwards and backwards (each
row's active keys; the products in split TF32, or the bytes), over the
device time of the kernels whose names match ``PATTERNS``, in %. Reads
nothing where no kernel matches."""

from benchmark.harness.yardstick import attention_backward_bound, attention_bound

PATTERNS = [r"flash_tf32_fwd_kernel", r"flash_bwd_dq_kernel", r"flash_bwd_dkdv_kernel"]


def read(run):
    if run.trace is None or not run.work or not run.work.get("attention_by_call"):
        return None
    n, seconds = run.trace.matching(PATTERNS)
    if n == 0 or seconds <= 0:
        return None
    by_call = run.work["attention_by_call"]
    bound = 0.0
    for call in sorted(by_call)[-run.traced_calls:]:
        for kind, *case in by_call[call]:
            bound += (attention_bound if kind == "fwd" else attention_backward_bound)(*case)
    return 100.0 * bound / seconds
