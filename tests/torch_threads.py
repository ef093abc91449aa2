"""One intra-op thread for torch in a test module that imports
:func:`one_torch_thread` (``from torch_threads import one_torch_thread``).

The suite runs six workers on the host's cores (``-n 6``). Each worker's
torch takes a pool of one thread a core for its CPU operations, so the
workers' plain versions, autograd references and toy models oversubscribe
the cores several times over and their pools spin against one another (the
emulated kernels' files, six workers on an 8-core host: the bf16 row
sampler's took 346 s with torch's default pools, 21 s with one thread). A
module that imports the fixture runs on one thread and gives the default
back when it ends.
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
