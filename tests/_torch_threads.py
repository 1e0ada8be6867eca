"""The port's test modules' intra-op thread fixture. It imports torch and
pytest alone, so the files that hold the port to its own rules (no JAX)
take it as well as those that hold it against the JAX package."""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for a module of small shapes (autouse where a
    test module imports it): the suite runs six workers on the host's
    cores, and with a thread a core in each, the tiny ops of these tests
    wait on each other (a serving file took 237 s in the parallel suite
    against 38 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
