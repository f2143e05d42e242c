"""The share of the traced window in which no operation ran on the card, in
%: the window's wall time (the span of the ``benchmark.window`` annotation
around the traced calls) less the union of the device operations inside it,
over that wall time. Both come from the one profiled window. Read for
``device_idle_pct.serve`` and ``device_idle_pct.train``."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
