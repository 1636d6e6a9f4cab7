"""One intra-op thread for torch in the port's CPU test modules.

The tier-1 run spreads the test files over six worker processes, and
each worker's torch would start a thread a core: the workers then fight
for the cores. A test module takes the pin with

    from torch_threads import one_torch_thread  # noqa: F401

which sets torch to one thread for that module's tests and restores the
count after them, so a module without the line runs as before.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
