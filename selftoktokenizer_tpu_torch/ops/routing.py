"""Which implementation the routers above the two kernels take.

``"cuda"`` (the default) sends every supported call to the kernel wrapper,
which launches the CUDA kernel for a CUDA tensor. ``"plain"`` sends it to
the kernel's plain PyTorch version instead; it exists so that a run on the
card can hold the whole path against itself with the kernels taken out, and
nothing else uses it. The wrappers themselves never read this.
"""

from __future__ import annotations

import contextlib

_route = "cuda"


def current():
    return _route


@contextlib.contextmanager
def kernel_route(name):
    global _route
    if name not in ("cuda", "plain"):
        raise ValueError(f"kernels must be 'cuda' or 'plain', got {name!r}")
    prev, _route = _route, name
    try:
        yield
    finally:
        _route = prev
