"""One PyTorch intra-op thread for each CPU test module of the port.

pytest-xdist runs the suite in several worker processes on the machine's
cores, and PyTorch gives each of them one intra-op thread a core by
default: the workers' threads then oversubscribe the CPU, and the port's
small tensor ops wait on one another. The port's test files on 6 workers
took 617 s with PyTorch's default and 140 s with one thread a worker
(the same 747 tests passing), on an 8-core CPU. Importing
``one_torch_thread`` into a test module turns it on for that module's
tests and restores the previous count after them; sizes, inputs and
tolerances stay as they are.
"""
import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
