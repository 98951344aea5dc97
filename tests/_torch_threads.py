"""One torch intra-op thread for the port's CPU tests.

Tier-1 runs six test processes at once on the machine's cores; torch's
default of one intra-op thread per core in every process oversubscribes
them, and the smoke-size ops of these tests gain nothing from more than
one.  A test module opts in with::

    from _torch_threads import one_torch_thread  # noqa: F401

(an autouse, module-scoped fixture: the setting is restored after the
module, so other modules in the same process keep theirs).
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
