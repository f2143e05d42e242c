"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity): the
denominators of every share of the card's peak that the port reports
(``chip_smoke.py``'s bounds, the ``tools/bench_*`` shares). The numerators
come from ``utils/flops.py`` or from a kernel's own count.

A share is only as true as the card's clocks: a card set below its 700 W
power limit runs slower under load, so every number stands beside the
card's name and power limit (``tools/common.py::card_line``).
"""

from __future__ import annotations

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores, fp32 accumulate
TF32_FLOPS = 495e12        # TF32 tensor cores
FP32_FLOPS = 67e12         # fp32 on the CUDA cores (TF32 off)
INT8_OPS = 1979e12         # int8 tensor cores
BYTES = 3.35e12            # HBM3 bytes a second

NAMES = {"bf16": (BF16_FLOPS, "H100 SXM bf16 tensor cores, 989 TFLOP/s"),
         "tf32": (TF32_FLOPS, "H100 SXM TF32 tensor cores, 495 TFLOP/s"),
         "fp32": (FP32_FLOPS, "H100 SXM fp32 CUDA cores, 67 TFLOP/s (TF32 off)"),
         "int8": (INT8_OPS, "H100 SXM int8 tensor cores, 1979 TOP/s")}


def share(flops_per_s, kind):
    """(share of the peak of ``kind``, the peak's name): flops_per_s over
    the H100's peak for 'bf16', 'tf32', 'fp32' or 'int8'."""
    peak, name = NAMES[kind]
    return flops_per_s / peak, name
