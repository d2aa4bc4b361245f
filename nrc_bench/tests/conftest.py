"""The benchmark's tests: on the CPU here, and the ``cuda`` ones on a card
(``python3 -m pytest nrc_bench/tests -m cuda``)."""

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card and nvcc; skips without one")


@pytest.fixture
def card():
    """The card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread, so that parallel workers do not fight over cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
