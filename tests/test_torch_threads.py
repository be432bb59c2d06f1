"""The port's CPU tests run PyTorch on one thread.

The tier runs six pytest workers on one host.  PyTorch gives each worker
an OpenMP pool of one thread per core, and the workers' pools together,
spinning while they wait for work, slow every worker: on eight cores the
port's test files took 617 s that way and 222 s with one PyTorch thread
a worker (``OMP_NUM_THREADS=1``).  Every ``tests/test_torch_*.py``
imports :func:`one_torch_thread`, an autouse fixture that holds PyTorch
to one thread for the module's tests and gives the count back after
them.  Results do not depend on it: the tests that compare bits already
run their PyTorch side on one thread.
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

IMPORT = "from test_torch_threads import one_torch_thread  # noqa: E402,F401"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_one_thread_in_a_test():
    assert torch.get_num_threads() == 1


def test_every_port_test_file_takes_the_fixture():
    here = Path(__file__).resolve()
    missing = [p.name for p in sorted(here.parent.glob("test_torch_*.py"))
               if p != here and IMPORT not in p.read_text()]
    assert not missing, missing
