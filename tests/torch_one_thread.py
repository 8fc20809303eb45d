"""One intra-op thread for torch in the port's CPU tests (no tests of its
own). The suite runs several pytest workers side by side; each torch
process otherwise starts one thread per core, and the workers' threads
then contend for the cores, which slows small ops most. A test module
imports the fixture:

    from torch_one_thread import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
