"""The port's public API matches the JAX package's, name for name and
signature for signature, by AST (nothing is imported, JAX least of all).

For every module under instantsplat_tpu/, the mirrored module under
instantsplat_tpu_torch/ must hold:

(a) each public top-level name (function, class, assignment) and each
    public method of a class present in both;
(b) for each function and public method present in both, the same
    positional parameters in the same order, as a caller sees them (no
    self/cls), under one rewrite table: port-only trailing device /
    generator / mesh / timings / native dropped, JAX-only interpret /
    block dropped, `params` read as `model` (also as a suffix:
    `lpips_params`) and `key` as `generator` on both sides;
(c) for each public dataclass and NamedTuple, every JAX field.

Every deliberate difference sits in EXCEPTIONS with its reason; a new
public name in the JAX package fails here until the port has it or the
table says why not.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_ROOT = REPO / "instantsplat_tpu"
PORT_ROOT = REPO / "instantsplat_tpu_torch"
JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT))
                     for p in JAX_ROOT.rglob("*.py"))

PORT_ONLY_TRAILING = {"device", "generator", "mesh", "timings", "native"}
JAX_ONLY = {"interpret", "block"}
RENAMED = {"params": "model", "key": "generator"}

_TPU = "a TPU tunable of the Pallas kernels' VMEM layout; the CUDA kernels " \
    "have their own (csrc/)"
_MAST3R = "the JAX MASt3R's functional API; the port's MASt3R is an " \
    "nn.Module (models/mast3r.py: MASt3R.cast/encode/decode/forward/" \
    "forward_from_encoded, load_upstream_state_dict, init_params_numpy, " \
    "DPTHead, CatMLPHead, the _rope grid)"
_CFG_DTYPE = "the port's MASt3R module carries its config and its dtype " \
    "(MASt3R.cast), so the call takes neither"
_RUNTIME = "parallel/runtime: the JAX one drives jax.distributed and " \
    "device meshes, the port's torch.distributed process groups; the " \
    "backends' own arguments differ"

# "<module>" (the whole module), "<module>::<name>", "<module>::<Class>.<field
# or method>" -> why the port differs there
EXCEPTIONS = {
    "native/__init__.py": "the EXR decoder's native build became "
    "data/exr.py over csrc/exr_native.cpp",
    "ops/rasterize_pallas.py::BLOCK_ROWS": _TPU,
    "ops/rasterize_pallas.py::CHUNKS_PER_STEP": _TPU,
    "ops/rasterize_pallas.py::G_CHUNK": _TPU,
    "ops/rasterize_pallas.py::MATMUL_PRECISION": _TPU,
    "ops/rasterize_pallas.py::STRIP_ROWS": _TPU,
    "ops/rasterize_pallas_tiled.py::SCAN_IMPL": _TPU,
    "render/driver.py::sort_payload": "the TPU's one-sort custom VJP "
    "(TPU scatter is serialized); torch.sort's backward is a gather",
    "pipelines/trainer.py::make_train_step": "became the eager "
    "pipelines/trainer.py::train_step",
    "pipelines/trainer.py::TrainerConfig.dispatch_budget_s": "the TPU's "
    "~60 s dispatch governor",
    "pipelines/train_pipeline.py::save_checkpoint_orbax": "orbax is a JAX "
    "library format; npz is the one both packages read",
    "pipelines/train_pipeline.py::load_checkpoint_orbax": "orbax, as above",
    "utils/transforms.py::Array": "the jax.Array type alias",
    "eval/image_metrics.py::LpipsVGG.conv_w": "LpipsVGG is an nn.Module: "
    "its weights are parameters (LpipsVGG.from_arrays(conv_w, conv_b, "
    "lin_w) takes these)",
    "eval/image_metrics.py::LpipsVGG.conv_b": "as conv_w",
    "eval/image_metrics.py::LpipsVGG.lin_w": "as conv_w",
    "models/mast3r.py::init_params": _MAST3R,
    "models/mast3r.py::cast_params": _MAST3R,
    "models/mast3r.py::convert_torch_checkpoint": _MAST3R,
    "models/mast3r.py::encode_images": _MAST3R,
    "models/mast3r.py::decode_pair": _MAST3R,
    "models/mast3r.py::forward_pair": _MAST3R,
    "models/mast3r.py::forward_from_encoded": _MAST3R,
    "models/mast3r.py::dpt_head": _MAST3R,
    "models/mast3r.py::catmlp_dpt_head": _MAST3R,
    "models/mast3r.py::patch_positions": _MAST3R,
    "models/mast3r.py::load_checkpoint": "loads into a MASt3R module "
    "(path, model), where JAX returns a parameter tree for a config",
    "models/mast3r_infer.py::infer_pairs": _CFG_DTYPE,
    "models/mast3r_infer.py::infer_pairs_mixed": _CFG_DTYPE,
    "parallel/runtime.py::initialize_runtime": _RUNTIME,
    "parallel/runtime.py::make_mesh_nd": _RUNTIME,
    "parallel/runtime.py::make_hybrid_mesh": _RUNTIME,
}


def _top_level(tree: ast.Module):
    """Module-level statements, with the bodies of if/try blocks opened."""
    todo = list(tree.body)
    while todo:
        node = todo.pop(0)
        if isinstance(node, (ast.If, ast.Try)):
            todo[:0] = (node.body + node.orelse
                        + [s for h in getattr(node, "handlers", [])
                           for s in h.body]
                        + getattr(node, "finalbody", []))
        else:
            yield node


def _definitions(tree: ast.Module, with_imports: bool) -> dict:
    """name -> defining node (FunctionDef, ClassDef, assignment, import)."""
    out = {}
    for node in _top_level(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for e in ast.walk(target):
                    if isinstance(e, ast.Name):
                        out[e.id] = node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = node
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = node
    return out


def _decorators(fn) -> set:
    return {ast.unparse(d).split("(")[0].split(".")[-1]
            for d in fn.decorator_list}


def _positional(fn, method: bool) -> list:
    """Positional parameter names as a caller passes them."""
    names = [a.arg for a in fn.args.posonlyargs + fn.args.args]
    if method and "staticmethod" not in _decorators(fn):
        names = names[1:]
    return names


def _renamed(name: str) -> str:
    if name.endswith("_params"):
        return name[:-len("params")] + "model"
    return RENAMED.get(name, name)


def _normalized(jax_names: list, port_names: list):
    """Apply the rewrite table to the two parameter lists."""
    j = [_renamed(a) for a in jax_names
         if not (a in JAX_ONLY and a not in port_names)]
    p = [_renamed(a) for a in port_names]
    # drop the port-only names of PORT_ONLY_TRAILING that only such names
    # follow
    tail = len(p)
    while tail and p[tail - 1] in PORT_ONLY_TRAILING:
        tail -= 1
    p = p[:tail] + [a for a in p[tail:] if a in j]
    return j, p


def _methods(cls: ast.ClassDef) -> dict:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _fields(cls: ast.ClassDef) -> list:
    """Names annotated in the class body."""
    return [n.target.id for n in cls.body
            if isinstance(n, ast.AnnAssign) and isinstance(n.target,
                                                           ast.Name)]


def _is_record(cls: ast.ClassDef) -> bool:
    """A dataclass or a NamedTuple."""
    return (any(ast.unparse(b).split(".")[-1] == "NamedTuple"
                for b in cls.bases)
            or "dataclass" in _decorators(cls))


def _sig_gap(key, jfn, pfn, method):
    j, p = _normalized(_positional(jfn, method), _positional(pfn, method))
    return [] if j == p else [(key, f"positional parameters: JAX {j}, "
                                    f"port {p}")]


def gaps(module: str, jax_src: str, port_src) -> list:
    """[(exception key, what differs)] of one module; port_src None when
    the port has no such file."""
    jdefs = {k: v for k, v in _definitions(ast.parse(jax_src),
                                           False).items()
             if not k.startswith("_")}
    if port_src is None:
        return [(module, f"no port module (public names {sorted(jdefs)})")]
    pdefs = _definitions(ast.parse(port_src), True)
    out = []
    for name, jnode in sorted(jdefs.items()):
        key = f"{module}::{name}"
        pnode = pdefs.get(name)
        if pnode is None:
            out.append((key, "missing in the port"))
            continue
        if isinstance(jnode, ast.FunctionDef) and isinstance(
                pnode, ast.FunctionDef):
            out += _sig_gap(key, jnode, pnode, False)
        if not (isinstance(jnode, ast.ClassDef)
                and isinstance(pnode, ast.ClassDef)):
            continue
        pmethods = _methods(pnode)
        for mname, jm in _methods(jnode).items():
            if mname.startswith("_"):
                continue
            mkey = f"{key}.{mname}"
            if mname not in pmethods:
                out.append((mkey, "method missing in the port"))
            else:
                out += _sig_gap(mkey, jm, pmethods[mname], True)
        if _is_record(jnode):
            pfields = _fields(pnode)
            out += [(f"{key}.{f}", "field missing in the port")
                    for f in _fields(jnode) if f not in pfields]
    return out


def module_gaps(module: str) -> list:
    port = PORT_ROOT / module
    return gaps(module, (JAX_ROOT / module).read_text(),
                port.read_text() if port.is_file() else None)


def _unexcused(found: list) -> list:
    return [f"{k}: {why}" for k, why in found if k not in EXCEPTIONS]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_port_matches_jax_public_api(module):
    bad = _unexcused(module_gaps(module))
    assert not bad, "\n".join(bad)


def test_every_exception_is_needed():
    """No stale entry: each exception covers a difference that exists."""
    found = {k for m in JAX_MODULES for k, _ in module_gaps(m)}
    stale = sorted(set(EXCEPTIONS) - found)
    assert not stale, stale


JAX_SRC = '''
from typing import NamedTuple
import dataclasses

SCALE = 2.0

def f(a, b, interpret=None): ...
def g(x): ...
def h(params, key): ...

class Out(NamedTuple):
    rgb: int
    depth: int

@dataclasses.dataclass
class Cfg:
    lr: float = 0.1
    steps: int = 3

    def scaled(self, k): ...
'''


def test_check_passes_port_idiom():
    """The rewrite table's differences pass."""
    port = JAX_SRC.replace("def f(a, b, interpret=None)",
                           "def f(a, b, device='cuda')").replace(
        "def h(params, key)", "def h(model, generator, device='cuda')")
    assert gaps("m.py", JAX_SRC, port) == []


def test_check_bites():
    """A missing name, a reordered parameter, a missing field and a
    missing method each fail the check, by name."""
    port = (JAX_SRC.replace("def f(a, b, interpret=None)", "def f(b, a)")
            .replace("def g(x): ...\n", "")
            .replace("    depth: int\n", "")
            .replace("    def scaled(self, k): ...\n", ""))
    found = dict(gaps("m.py", JAX_SRC, port))
    assert set(found) == {"m.py::f", "m.py::g", "m.py::Out.depth",
                          "m.py::Cfg.scaled"}, found
    assert "JAX ['a', 'b'], port ['b', 'a']" in found["m.py::f"]
    # a port-only name in the middle of the list is not port idiom
    mid = JAX_SRC.replace("def g(x)", "def g(device, x)")
    assert set(dict(gaps("m.py", JAX_SRC, mid))) == {"m.py::g"}
    assert gaps("m.py", JAX_SRC, None)[0][0] == "m.py"
