"""The benchmark's own tests: run from the repository root with
`python -m pytest benchmark/tests -q` (CPU), and on a CUDA machine the
`cuda`-marked ones with `python -m pytest benchmark/tests -q -m cuda`."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skips without one")
