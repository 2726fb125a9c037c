"""The thread policy of the port's CPU tests.  Every tests/test_torch_*.py
module takes it by importing the fixture (pytest finds fixtures in a
module's globals):

    from torch_cpu import one_torch_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one torch thread: the suite runs several workers at once,
    and at the tests' batch sizes torch's pool of a thread per core only makes
    the small ops wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
