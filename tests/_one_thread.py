"""Torch held to one intra-op thread for a test module (import the fixture).

The port's CPU tests run tiny shapes, where torch's time is op overhead:
with several test workers on the machine, each worker's default intra-op
threads only contend (about 35x slower).  A module that imports
`one_thread` runs its tests on one thread and restores the count after.
"""

import pytest


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
