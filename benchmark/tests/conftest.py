"""Card-only tests carry the ``gpu`` marker and take the ``cuda`` fixture,
which decides at run time, never at import."""

import pytest
import torch

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
