"""Tests of the benchmark. Run from the root of the repository:

    python -m pytest ecbench/tests -q            # CPU (tests marked cuda skip)
    python -m pytest ecbench/tests -q -m cuda    # on the card
"""

import pytest
import torch

from ecbench import spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def tiny_cell(name: str):
    """The cell ``name`` at a size the CPU runs in a second: 32 KiB cells,
    4 stripes a block group, 2 block groups, 2 stripes an encode call,
    0.2 s of warm-up."""
    cell = spec.load_cell(name)
    cell.config.update(cell_bytes=32768, resident_block_groups=2,
                       block_bytes=4 * 32768)
    if cell.traffic["request"] == "encode":
        cell.traffic["stripes_per_call"] = 2
    else:
        cell.traffic["warm_seconds"] = 0.2
    cell.traffic.update(check_within=6, check_answers=3)
    return cell
