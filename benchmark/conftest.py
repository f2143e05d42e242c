"""The benchmark's own tests: ``python -m pytest benchmark/tests``.

Tests marked ``card`` need a CUDA device; without one they skip, deciding
inside the test. Run them on the card with
``python -m pytest benchmark/tests -m card``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device (skips without one)")
