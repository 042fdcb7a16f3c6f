"""portbench's own tests: python -m pytest portbench/tests -q -p no:cacheprovider
(the card's tests carry the `cuda` marker and skip where there is no card)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card and toolkit; skips where there is none")
