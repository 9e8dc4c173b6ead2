"""CPU tests of the benchmark (run with `python -m pytest benchmark/tests`
from the repository's root; the repository's own suite does not collect
them). Tests that need the card are marked `gpu` and skip elsewhere; the
`cuda` fixture decides, never the import."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny_cell(name: str):
    """The cell with its sizes cut for a CPU test: 24 x 40 images (the
    points stage 1 keeps for them), 40 iterations logged every 20."""
    from benchmark.core import manifest

    cell = manifest.cell(name)
    cell.config = dict(cell.config, iterations=40, log_every=20, height=24,
                       width=40)
    return cell
