"""On the card, at each cell's own size: the control (the program's own path
one precision below the configuration's: the int8 decoder for bf16 with
the reference's float8 VAE in the bf16 VAE's place, the TF32 encode tier
and TF32 training for fp32 with TF32 off) reads ``correct`` false on three
seeds, and the program reads it true.

    python -m pytest benchmark/tests/test_controls.py -m card

About ten minutes on an H100: each seed builds the 2.3 B-parameter
program and runs the fp32 reference once.
"""

from __future__ import annotations

import pytest

from benchmark.tests.helpers import need_card
from benchmark.tools.calibrate import readings

CELLS = ["flagship-256.decode-bf16-b32", "flagship-renderer-256.render-bf16-b32",
         "flagship-256.encode-highest-b32", "flagship-256.train-fp32-b4"]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(workload):
    need_card()
    assert all(r["correct"] is False
               for r in readings(workload, [4_000_000_001, 4_000_000_002, 4_000_000_003],
                                 control=True))
    assert all(r["correct"] is True for r in readings(workload, [4_000_000_004]))
