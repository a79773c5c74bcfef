"""Tests of the benchmark itself. They run on the CPU at tiny sizes; a
test that needs a card carries the `cuda` marker and decides inside the
test whether there is one.

    python -m pytest benchmark/tests -q          # from the repository root
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")
