"""COLMAP sparse-model I/O (text + binary), host-side numpy.

Port of instantsplat_tpu/data/colmap.py (numpy only, so the code is the
same; the port keeps its own copy). Clean-room implementation of the
COLMAP reconstruction file formats the reference pipeline reads and
writes (behavior documented at
scene/colmap_loader.py and utils/sfm_utils.py:202-247 — the formats
themselves are the public COLMAP spec, src/base/reconstruction.cc):

- cameras.{bin,txt}: intrinsics records (we emit PINHOLE like the
  reference's save_intrinsics, sfm_utils.py:230-247);
- images.{bin,txt}: world-to-camera extrinsics as (qvec wxyz, tvec) plus an
  empty 2D-point track list (sfm_utils.py:225: xys/point3D_ids left empty).

The fused point cloud travels as points3D.ply (data/ply.py), so the
points3D.{bin,txt} readers and writers are not ported.

These files are the stage-coupling artifact between init_geo and
train/render (SURVEY.md §1), so byte-level format compatibility matters:
a scene initialized by the reference can be trained by this framework and
vice versa.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

from instantsplat_tpu_torch.utils.transforms import (  # noqa: F401
    qvec_to_rotmat,
    rotmat_to_qvec,
)

CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": (0, 3),
    "PINHOLE": (1, 4),
    "SIMPLE_RADIAL": (2, 4),
    "RADIAL": (3, 5),
    "OPENCV": (4, 8),
    "OPENCV_FISHEYE": (5, 8),
    "FULL_OPENCV": (6, 12),
    "FOV": (7, 5),
    "SIMPLE_RADIAL_FISHEYE": (8, 4),
    "RADIAL_FISHEYE": (9, 5),
    "THIN_PRISM_FISHEYE": (10, 12),
}
_MODEL_BY_ID = {mid: (name, n) for name, (mid, n) in CAMERA_MODEL_IDS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # PINHOLE: [fx, fy, cx, cy]


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # [4] wxyz, world-to-camera rotation
    tvec: np.ndarray  # [3] world-to-camera translation
    camera_id: int
    name: str
    xys: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0,), np.int64))

    @property
    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = qvec_to_rotmat(self.qvec)
        m[:3, 3] = self.tvec
        return m


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def read_cameras_text(path) -> dict[int, ColmapCamera]:
    cameras = {}
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        e = line.split()
        cameras[int(e[0])] = ColmapCamera(
            id=int(e[0]), model=e[1], width=int(e[2]), height=int(e[3]),
            params=np.array([float(x) for x in e[4:]]),
        )
    return cameras


def write_cameras_text(cameras: dict[int, ColmapCamera], path):
    lines = [
        "# Camera list with one line of data per camera:",
        "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]",
        f"# Number of cameras: {len(cameras)}",
    ]
    for cam in cameras.values():
        params = " ".join(str(float(p)) for p in cam.params)
        lines.append(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}")
    Path(path).write_text("\n".join(lines) + "\n")


def read_cameras_binary(path) -> dict[int, ColmapCamera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _MODEL_BY_ID[mid]
            params = struct.unpack(f"<{n_params}d", f.read(8 * n_params))
            cameras[cid] = ColmapCamera(cid, name, int(w), int(h),
                                        np.array(params))
    return cameras


def write_cameras_binary(cameras: dict[int, ColmapCamera], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            mid, n_params = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{n_params}d", *map(float, cam.params)))


# ---------------------------------------------------------------------------
# images (extrinsics)
# ---------------------------------------------------------------------------


def read_images_text(path) -> dict[int, ColmapImage]:
    images = {}
    # comments are dropped, but EMPTY lines are kept: an image with no 2D
    # points writes an empty second line, which still belongs to the
    # head/points line pairing.
    lines = [
        ln.strip() for ln in Path(path).read_text().splitlines()
        if not ln.strip().startswith("#")
    ]
    while lines and not lines[0]:
        lines.pop(0)
    if len(lines) % 2:  # final empty points-line lost to splitlines
        lines.append("")
    for head, pts in zip(lines[0::2], lines[1::2]):
        e = head.split()
        iid = int(e[0])
        xys_ids = pts.split()
        xys = np.array(
            [[float(x), float(y)] for x, y in zip(xys_ids[0::3], xys_ids[1::3])]
        ).reshape(-1, 2)
        p3d = np.array([int(i) for i in xys_ids[2::3]], np.int64)
        images[iid] = ColmapImage(
            id=iid,
            qvec=np.array([float(v) for v in e[1:5]]),
            tvec=np.array([float(v) for v in e[5:8]]),
            camera_id=int(e[8]),
            name=e[9],
            xys=xys,
            point3D_ids=p3d,
        )
    return images


def write_images_text(images: dict[int, ColmapImage], path):
    lines = [
        "# Image list with two lines of data per image:",
        "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
        "#   POINTS2D[] as (X, Y, POINT3D_ID)",
        f"# Number of images: {len(images)}",
    ]
    for im in images.values():
        q = " ".join(str(float(v)) for v in im.qvec)
        t = " ".join(str(float(v)) for v in im.tvec)
        lines.append(f"{im.id} {q} {t} {im.camera_id} {im.name}")
        pts = " ".join(
            f"{x} {y} {pid}"
            for (x, y), pid in zip(im.xys, im.point3D_ids)
        )
        lines.append(pts)
    Path(path).write_text("\n".join(lines) + "\n")


def read_images_binary(path) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            vals = struct.unpack("<idddddddi", f.read(64))
            iid, cam_id = vals[0], vals[8]
            qvec, tvec = np.array(vals[1:5]), np.array(vals[5:8])
            name = b""
            while (ch := f.read(1)) != b"\x00":
                name += ch
            (n2d,) = struct.unpack("<Q", f.read(8))
            data = struct.unpack("<" + "ddq" * n2d, f.read(24 * n2d))
            xys = np.array(
                [[data[3 * i], data[3 * i + 1]] for i in range(n2d)]
            ).reshape(-1, 2)
            p3d = np.array([data[3 * i + 2] for i in range(n2d)], np.int64)
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, p3d)
    return images


def write_images_binary(images: dict[int, ColmapImage], path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack(
                "<idddddddi", im.id, *map(float, im.qvec),
                *map(float, im.tvec), im.camera_id,
            ))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", float(x), float(y), int(pid)))
