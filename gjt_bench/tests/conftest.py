"""Tests of the benchmark harness. Run from the repo root:

    python -m pytest gjt_bench/tests -q

Tests that need the card carry the `card` marker and skip elsewhere (the
`card` fixture decides, at run time).
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda", 0)
