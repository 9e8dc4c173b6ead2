"""The PyTorch port stands alone: no module of instantsplat_tpu_torch, nor
chip_smoke.py, nor a script that measures the port (scripts/torch_*.py),
imports JAX, Flax, Optax or the JAX package."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "instantsplat_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "scripts").glob("torch_*.py"))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "instantsplat_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in FORBIDDEN


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (REPO / "instantsplat_tpu_torch" / "csrc" / "rasterize.cu").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_rule_catches_forbidden_names():
    assert _forbidden("jax.numpy") and _forbidden("instantsplat_tpu.ops")
    assert _forbidden("optax") and _forbidden("flax.linen")
    assert not _forbidden("instantsplat_tpu_torch.ops.rasterize")
    assert not _forbidden("torch")


def test_step_loops_know_no_renderer():
    """utils/cuda_graphs.py (every device-resident loop's StepLoop) imports
    nothing of the render layer or of the compositors: the loops that
    render bracket their own runs with the driver's overflow guard."""
    path = REPO / "instantsplat_tpu_torch" / "utils" / "cuda_graphs.py"
    bad = [m for m in _imported_modules(path)
           if m.startswith("instantsplat_tpu_torch.render")
           or m.startswith("instantsplat_tpu_torch.ops.rasterize")]
    assert not bad, f"utils/cuda_graphs.py imports {bad}"
