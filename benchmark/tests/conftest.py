import pytest
import torch


@pytest.fixture
def card():
    """The card, or a skip where torch sees none (decided in the test,
    never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
