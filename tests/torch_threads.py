"""One CPU thread for PyTorch in a test module of the port, and in the
processes it starts.

PyTorch splits a CPU op on a tensor of more than 32768 elements over a
pool of as many threads as the machine has cores, and ends each op at a
barrier for all of them.  The kernels' plain versions are Python loops
of many such ops (a row of an M = 9000 model over a batch of ORFs is
past that size), and ``pytest -n 6`` on an eight-core machine runs six
workers, each with its own pool of eight: every barrier then waits for
threads that the scheduler has put off.  There,
``test_torch_long_models.py::test_integer_plain_versions_match_the_host_reference[9000]``
took 782 s against 5 s with one thread.  A module takes one thread by
importing ``one_torch_thread`` (an autouse fixture); what it computes
does not change.
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
