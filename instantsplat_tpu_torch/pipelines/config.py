"""CLI parameter groups and the persisted cfg_args (port of
instantsplat_tpu/pipelines/config.py): dataclass fields become --flags,
booleans become store_true, and training writes the merged namespace to
<model_path>/cfg_args, which the later stages merge with their command
line (`get_combined_args`). Both packages write and read the same file."""

from __future__ import annotations

import dataclasses
import os
from argparse import ArgumentParser, Namespace
from pathlib import Path

from instantsplat_tpu_torch.opt.gaussian_opt import OptimizationConfig


@dataclasses.dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    n_views: int = 0
    init_scale_from_view_depth: bool = False


@dataclasses.dataclass
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    # rasterizer backend: auto (training probes the dense kernels against
    # a capacity backend sized for the scene and keeps the faster; both
    # exact) | pallas (dense, K1/K2) | pallas-binned[:CF:DL] (K3/K4) |
    # pallas-tiled[:CF:DY:DX] (K5/K6) | oracle (plain PyTorch)
    backend: str = "auto"


def add_group(parser: ArgumentParser, cls_or_obj, abbrevs=()):
    """Register one dataclass's fields as CLI args."""
    obj = cls_or_obj() if isinstance(cls_or_obj, type) else cls_or_obj
    ab = dict(abbrevs)
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        flags = [f"--{f.name}"] + ([f"-{ab[f.name]}"] if f.name in ab else [])
        if isinstance(val, bool):
            parser.add_argument(*flags, action="store_true", default=val)
        else:
            parser.add_argument(*flags, type=type(val), default=val)
    return obj


def extract_group(args: Namespace, cls):
    obj = cls()
    for f in dataclasses.fields(obj):
        if hasattr(args, f.name):
            setattr(obj, f.name, getattr(args, f.name))
    if getattr(obj, "source_path", ""):
        obj.source_path = os.path.abspath(obj.source_path)
    return obj


def make_opt_config(args: Namespace) -> OptimizationConfig:
    return OptimizationConfig(**{
        f.name: getattr(args, f.name)
        for f in dataclasses.fields(OptimizationConfig)
        if hasattr(args, f.name)})


def save_cfg_args(model_path, args: Namespace):
    """Dump the Namespace repr to <model_path>/cfg_args."""
    Path(model_path).mkdir(parents=True, exist_ok=True)
    with open(Path(model_path) / "cfg_args", "w") as f:
        f.write(str(Namespace(**vars(args))))


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """The saved <model_path>/cfg_args (a Namespace repr) merged with the
    command line: a value given on the command line (one that differs from
    the parser's default) wins, and so does any name the file lacks."""
    cmdline = parser.parse_args(argv)
    try:
        text = (Path(cmdline.model_path) / "cfg_args").read_text()
    except (OSError, AttributeError, TypeError):
        return cmdline
    saved = eval(text, {"__builtins__": {}}, {"Namespace": Namespace})
    merged = vars(saved).copy()
    defaults = vars(parser.parse_args([]))
    for k, v in vars(cmdline).items():
        if k not in merged or v != defaults.get(k):
            merged[k] = v
    return Namespace(**merged)
