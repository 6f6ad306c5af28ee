"""An autouse fixture for the port's analysis tests: each test runs torch on
one CPU thread. Import it into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's loops here (Newton, Lloyd, Sinkhorn, t-SNE) run thousands
    of tiny torch ops; beside the suite's other workers, torch's CPU thread
    pool makes each op wait on busy cores (a 300-step Sinkhorn took 14.6 s
    with 8 threads against 0.15 s with one), so these tests use one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
