"""Settings of the benchmark's own tests:

    python -m pytest perfbench/tests -q

The tests marked ``chip`` need the card and skip without one; on the
card they run as ``python -m pytest perfbench/tests -q -m chip``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs the CUDA card; skips without one")
