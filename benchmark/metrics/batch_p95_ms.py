"""The 95th percentile (nearest rank) of the wall time of every call in the
timed window, each ending in a synchronize, in milliseconds."""

from benchmark.harness.window import percentile


def read(run):
    return percentile(run.window.call_s, 95) * 1e3
