"""Kernels a decode call: every kernel the traced window ran (the codebook
context, the 50 sampler steps and the VAE decode) over its calls. A count
of the sampler's steps alone waits for a span around them in the program."""


def read(run):
    if run.trace is None or not run.traced_calls:
        return None
    return len(run.trace.kernels()) / run.traced_calls
