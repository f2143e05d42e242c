"""The timed window's wall time over its optimizer steps: every step on
fresh rows, the window ending in a synchronize after the last."""


def read(run):
    return run.window.seconds / run.window.calls
