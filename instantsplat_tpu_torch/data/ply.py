"""PLY I/O without external deps: colored point clouds and 3DGS Gaussian
plys (port of instantsplat_tpu/data/ply.py; byte-identical files).

- point-cloud ply: vertex = (x y z f4, nx ny nz f4, red green blue u1);
- Gaussian-model ply: vertex = (x y z, nx ny nz, f_dc_0..2,
  f_rest_0..{3K-4}, opacity, scale_0..2, rot_0..3), all f4, with the SH
  rest coefficients stored channel-major ([N, K-1, 3] -> [N, 3, K-1]).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from instantsplat_tpu_torch.models.gaussians import GaussianModel


def _write_ply(path, named_arrays):
    """One binary_little_endian 'vertex' element; u1 arrays stay uchar,
    everything else is written f4."""
    n = len(named_arrays[0][1])
    dtype = [(name, "u1" if arr.dtype == np.uint8 else "f4")
             for name, arr in named_arrays]
    rec = np.empty(n, dtype=dtype)
    for name, arr in named_arrays:
        rec[name] = arr
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, arr in named_arrays:
        t = "uchar" if arr.dtype == np.uint8 else "float"
        header.append(f"property {t} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        rec.tofile(f)


_TYPES = {
    b"float": np.float32, b"float32": np.float32,
    b"double": np.float64, b"float64": np.float64,
    b"uchar": np.uint8, b"uint8": np.uint8,
    b"char": np.int8, b"short": np.int16, b"ushort": np.uint16,
    b"int": np.int32, b"int32": np.int32, b"uint": np.uint32,
}


def _read_ply(path):
    """-> dict name -> np array (binary LE or ascii, single vertex element)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"not a ply file: {path}")
        fmt = f.readline().split()[1]
        props, n = [], 0
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"element":
                if parts[1] != b"vertex" and n:
                    raise ValueError("only single-vertex-element plys")
                n = int(parts[2])
            elif parts[0] == b"property":
                if parts[1] == b"list":
                    raise ValueError("list properties unsupported")
                props.append((parts[2].decode(), _TYPES[parts[1]]))
        if fmt == b"ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n).reshape(n, -1)
            return {name: data[:, i].astype(t)
                    for i, (name, t) in enumerate(props)}
        rec = np.fromfile(f, dtype=np.dtype(props), count=n)
    return {name: rec[name] for name, _ in props}


def store_point_cloud(path, xyz, rgb):
    """rgb in [0, 255]; normals written as zeros (reference storePly)."""
    xyz = np.asarray(xyz, np.float32)
    rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
    zeros = np.zeros(len(xyz), np.float32)
    _write_ply(path, [
        ("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
        ("nx", zeros), ("ny", zeros), ("nz", zeros),
        ("red", rgb[:, 0]), ("green", rgb[:, 1]), ("blue", rgb[:, 2]),
    ])


def fetch_point_cloud(path):
    """-> (xyz [N,3] f32, colors [N,3] in [0,1])."""
    d = _read_ply(path)
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    rgb = np.stack([d["red"], d["green"], d["blue"]], -1).astype(np.float32)
    return xyz, rgb / 255.0


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def save_gaussian_ply(path, params: GaussianModel):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    xyz = _np(params.xyz)
    n = len(xyz)
    zeros = np.zeros(n, np.float32)
    cols = [("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2]),
            ("nx", zeros), ("ny", zeros), ("nz", zeros)]
    f_dc = _np(params.features_dc).transpose(0, 2, 1).reshape(n, -1)
    cols += [(f"f_dc_{i}", f_dc[:, i]) for i in range(f_dc.shape[1])]
    f_rest = _np(params.features_rest).transpose(0, 2, 1).reshape(n, -1)
    cols += [(f"f_rest_{i}", f_rest[:, i]) for i in range(f_rest.shape[1])]
    cols.append(("opacity", _np(params.opacity)[:, 0]))
    scaling = _np(params.scaling)
    cols += [(f"scale_{i}", scaling[:, i]) for i in range(scaling.shape[1])]
    rotation = _np(params.rotation)
    cols += [(f"rot_{i}", rotation[:, i]) for i in range(rotation.shape[1])]
    _write_ply(path, cols)


def load_gaussian_ply(path, max_sh_degree=3, cam_poses=None,
                      device="cuda") -> GaussianModel:
    d = _read_ply(path)
    n = len(d["x"])
    xyz = np.stack([d["x"], d["y"], d["z"]], -1).astype(np.float32)
    opacity = np.asarray(d["opacity"], np.float32)[:, None]
    f_dc = np.stack([d[f"f_dc_{i}"] for i in range(3)], -1)[:, None, :]
    k = (max_sh_degree + 1) ** 2
    rest_names = sorted((name for name in d if name.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    if len(rest_names) != 3 * (k - 1):
        raise ValueError(f"{path}: {len(rest_names)} f_rest columns, "
                         f"expected {3 * (k - 1)} for SH degree "
                         f"{max_sh_degree}")
    f_rest = np.stack([d[name] for name in rest_names], -1)
    f_rest = f_rest.reshape(n, 3, k - 1).transpose(0, 2, 1)
    scaling = np.stack([d[f"scale_{i}"] for i in range(3)], -1)
    rotation = np.stack([d[f"rot_{i}"] for i in range(4)], -1)
    if cam_poses is None:
        cam_poses = np.zeros((0, 7), np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    return GaussianModel(xyz=t(xyz), features_dc=t(f_dc),
                         features_rest=t(f_rest), scaling=t(scaling),
                         rotation=t(rotation), opacity=t(opacity),
                         cam_poses=t(cam_poses), max_sh_degree=max_sh_degree)
