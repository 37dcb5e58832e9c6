"""The benchmark's own tests: on the CPU at tiny sizes, and, marked
``gpu``, on a CUDA card (they skip where there is none).

    python -m pytest h100_bench/tests -q              # CPU
    python3 -m pytest h100_bench/tests -q -m gpu      # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
