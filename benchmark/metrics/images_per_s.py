"""Images completed over the whole timed window: every call's batch, over
the first call's start to the last call's end."""


def read(run):
    return run.window.calls * run.images_per_call / run.window.seconds
