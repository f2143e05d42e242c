"""selftoktokenizer_tpu_torch: the PyTorch / CUDA port of the Selftok tokenizer.

The JAX package ``selftoktokenizer_tpu`` is the reference; this package is
its counterpart for an NVIDIA Hopper GPU. Sub-packages mirror the reference
(``core/``, ``ops/``, ``models/``, ``pipeline/``) so every function has a
findable twin. Plain tensor code is PyTorch; the two kernels on the serving
path (``ops/vq_kernels.py``, ``ops/flash_attention.py``) are CUDA C++ under
``csrc/``, built with ``nvcc`` at first use. Nothing here imports ``jax`` or
the reference package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
nothing falls back to the CPU on its own.
"""

__version__ = "0.1.0"

from selftoktokenizer_tpu_torch.core.config import AttrDict, load_config  # noqa: F401
