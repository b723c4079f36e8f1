"""One torch thread for a whole test module: import ``one_torch_thread`` into it.

The tier-1 command runs a file on each of 6 workers on an 8-core machine, and
each worker's torch would start 8 threads, whose pools then contend. Under
that load one thread is the faster: ``test_torch_train_kernels.py``'s route
test took 110.8 s at 8 threads beside five busy processes and 1.6 s at one
(1.2 s and 1.4 s alone).
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
