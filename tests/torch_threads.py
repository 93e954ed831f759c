"""One torch intra-op thread for each of the port's test modules.

The suite runs several pytest workers (``-n 6``) on a few cores.  There
torch's intra-op threads only wait on each other: a small multiply on a
2x2 simulated mesh took 1.1 s on eight threads against 0.014 s on one.
A port test module takes the fixture by importing it:

    from torch_threads import one_thread  # noqa: F401

The module's tests then run on one thread, and the worker's count comes
back after the module.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
