"""Nothing the benchmark runs loads JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference takes nothing from the program."""

import ast
import subprocess
import sys

from benchmark.core import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "instantsplat_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_source_under_benchmark_imports_jax():
    for path in manifest.BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (manifest.BENCH / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert tops <= {"__future__", "contextlib", "math", "numpy", "torch"}, \
            (path, tops)


def test_loading_every_entry_and_the_program_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(manifest.ROOT)!r})\n"
        "from benchmark.core import manifest, device\n"
        "import json\n"
        "man = json.loads((manifest.ROOT / 'BENCHMARK.json').read_text())\n"
        "for w in man['workloads']:\n"
        "    c = manifest.cell(w['name']); c.entry()\n"
        "    [manifest.metric_reader(m['name']) for m in c.per_layer]\n"
        "import instantsplat_tpu_torch.pipelines.train_pipeline\n"
        "import instantsplat_tpu_torch.cli.train\n"
        "print(device.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_check_compares_whole_top_level_names():
    from benchmark.core import device

    sys.modules.setdefault("instantsplat_tpu_torch_x", sys)
    try:
        assert "instantsplat_tpu" not in device.forbidden_modules()
    finally:
        del sys.modules["instantsplat_tpu_torch_x"]
