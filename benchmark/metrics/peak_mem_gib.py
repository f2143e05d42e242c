"""The most device memory the timed window held (``max_memory_allocated``
after a reset at its start), in GiB. Read for ``peak_mem_gib.serve`` and
``peak_mem_gib.train``."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
