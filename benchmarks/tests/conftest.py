import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the test
    runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest benchmarks/tests -m card` "
                    "on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    """Bit-steady CPU arithmetic: one intra-op thread while a test runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
