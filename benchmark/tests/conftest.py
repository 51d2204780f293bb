"""Tests of the benchmark harness: the reference at tiny sizes, the import
guard, and runs of the harness on the CPU at small sizes with the control
and faults planted. Run with `python -m pytest benchmark/tests` from the
repository's root; tests marked gpu skip without a CUDA card."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """cuda:0, or a skip where the machine has no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
