"""The harness's CPU tests import the program from the checkout's ``src``,
as `run.py` does."""

import os
import sys

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The harness's CPU tests run small cells: one intra-op thread each,
    so that the suite's parallel workers do not oversubscribe the cores."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
