"""The port's CPU test files share the cores fairly with the other
xdist workers (the fixture lives here, and this file checks it).

Two torch processes whose 8-thread intra-op pools shared 8 cores slowed
each other's ops about 45x (the pod drill of
``tests/test_torch_pods.py``: 226 s against 5 s alone); with one thread
each they did not slow at all.  So while a port test file runs, its
worker takes its share of the cores (one thread under 6 workers on 8
cores, all of them without xdist).  A port test file imports the
fixture, which holds for the whole file:

    from test_torch_threads import intra_op_share  # noqa: F401
"""

import os

import pytest
import torch


def _share() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(autouse=True, scope="module")
def intra_op_share():
    n = torch.get_num_threads()
    torch.set_num_threads(_share())
    yield
    torch.set_num_threads(n)


def test_intra_op_threads_are_the_workers_share():
    assert torch.get_num_threads() == _share()
