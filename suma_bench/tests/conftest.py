"""The benchmark's tests. Those that need a CUDA card carry the ``card``
marker and skip, with a reason, where none is found: the decision is made in
the ``cuda_device`` fixture, never while a module is imported. Run them on
the card with ``python3 -m pytest suma_bench/tests -m card -n 0``."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips with a reason elsewhere")


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    """Several workers share the machine: two threads each."""
    import torch
    torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the card's "
                    "precisions")
    return "cuda"
