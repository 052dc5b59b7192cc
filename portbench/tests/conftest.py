"""Settings of the benchmark's own tests (``python -m pytest portbench/tests``
from the repo root).  Tests that need a CUDA device take the ``card``
fixture, which skips them here; they run on a machine with the card."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (an NVIDIA H100)")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny():
    """The sizes of the CPU runs: every cell's shapes cut, and limits that
    the tiny sound runs keep (their readings are a few times lower)."""
    return {"config": {"n": 40},
            "mix": {"run": {"n_chains": 64, "iter": 200, "corr_batch": 512},
                    "check": {"heads": 512, "particles_ref": 2048,
                              "grid": 12}},
            "limits": {"approx_post_gap": 0.02, "is_mean_gap": 0.05,
                       "is_noise_gap": 0.2, "chain_moment_gap": 0.5}}
