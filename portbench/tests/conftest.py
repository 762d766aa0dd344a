import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")


@pytest.fixture(autouse=True)
def one_thread():
    """The benchmark's CPU tests run small models: one thread each keeps
    them from crowding the other tests of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
