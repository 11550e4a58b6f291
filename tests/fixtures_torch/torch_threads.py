"""One ATen intra-op thread per pytest-xdist worker, for the port's tests.

Several workers share the machine's cores, and ATen's OpenMP threads of
every worker spinning on the plain versions' elementwise ops oversubscribe
them: a forced-dense town rollout took 402 s instead of 6 s, and a single
thread runs the small simple_map cases faster than eight even alone. A
test module takes the fixture by importing it:

    from torch_threads import one_thread_under_xdist  # noqa: F401
"""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread_under_xdist():
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
