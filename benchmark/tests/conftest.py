"""The benchmark's own tests: on the CPU at a tiny size, except those marked
`card`, which need an NVIDIA GPU and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every configuration and mix at a size the CPU runs in seconds
TINY = dict(image_size=48, conv_dim=8, repeat_num=2, num_objects=2, batch=2, pool_batches=2,
            reference_rows=1, checked_from_first=2, checked_calls=1, warmup_calls=1)
CELLS = ("ho3dv3.train_bf16_b32", "dexycb.serve_b16", "dexycb.train_bf16_b32")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
