"""Seeded synthetic scenes in the stage-1 output layout that stage 2 reads.

A textured relief surface z = 0.3 sin(1.7 x) cos(2.3 y), seen by V cameras
on an arc of radius 4, 0.3 above the surface's centre. The point cloud is
what stage 1 writes for such views: one point a pixel (here the pixel's
exact surface point), less the pixels that stage 1's co-visibility rule
drops (`co_visible`), so its size follows from the views and is the same
for every seed. Each scene folder holds:

  images/000.png ...                 ray-cast views (8-bit RGB)
  sparse_V/0/cameras.txt             PINHOLE, fx = fy = 0.9 W, centre W/2, H/2
  sparse_V/0/images.txt              each view's w2c, perturbed from the truth
                                     (stage 1's poses are estimates)
  sparse_V/0/points3D.ply            the kept pixels' points, their colours
  sparse_V/0/confidence_dsp.npy      a MASt3R-like confidence per point

The writers are this file's own (PNG, binary ply, COLMAP text), so the
benchmark depends on the program only for what it measures. The same seed
gives the same bytes; every seed gives the same sizes. `Scene` keeps the
arrays as written, for the plain reference.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from pathlib import Path

import numpy as np

DIST = 4.0  # the cameras' distance from the surface's centre
HEIGHT_ABOVE = 0.3
FOCAL_SHARE = 0.9  # fx = fy = 0.9 W
POSE_JITTER_RAD = 0.005  # stage 1's pose error: ~0.3 degree, 0.02 of 4
POSE_JITTER_T = 0.02


def surface(x, y):
    return 0.3 * np.sin(1.7 * x) * np.cos(2.3 * y)


def texture(x, y):
    c = np.stack([0.5 + 0.4 * np.sin(3.0 * x + 0.5 * y),
                  0.5 + 0.4 * np.cos(2.0 * y - 1.3 * x),
                  0.5 + 0.4 * np.sin(1.1 * x * y + 2.0)], -1)
    checker = ((np.floor(2 * x) + np.floor(2 * y)) % 2)[..., None]
    return np.clip(c * (0.75 + 0.25 * checker), 0.0, 1.0)


def look_at_w2c(eye, target=(0.0, 0.0, 0.0), up=(0.0, -1.0, 0.0)):
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd], axis=0)  # rows: camera axes in world
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = -R @ eye
    return M


def ray_cast(w2c, fx, height, width):
    """The relief seen by `w2c` (pixel centres at integers, principal point
    ((W - 1) / 2, (H - 1) / 2)): -> ([H, W, 3] world points, [H, W]
    camera-frame depths)."""
    gy, gx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    c2w = np.linalg.inv(w2c)
    d = np.stack([(gx - (width - 1) / 2) / fx, (gy - (height - 1) / 2) / fx,
                  np.ones_like(gx, np.float64)], -1) @ c2w[:3, :3].T
    o = c2w[:3, 3]
    t = -o[2] / d[..., 2]  # plane z = 0, then fixed-point refinement
    for _ in range(8):
        p = o + t[..., None] * d
        t = (surface(p[..., 0], p[..., 1]) - o[2]) / d[..., 2]
    p = o + t[..., None] * d
    return p, (p - o) @ np.asarray(w2c)[2, :3]


def co_visible(order, depth, points, fx, w2cs, depth_thre):
    """[V, H, W] True where a pixel is co-visible with a view ranked before
    it: stage 1's co-visibility rule (InstantSplat utils/sfm_utils.py
    compute_co_vis_masks, run by `init_geo.py --co_vis_dsp`), frozen here.
    The points of the views before are projected into the view, and a
    pixel they land on is co-visible where their min-max normalised depth
    (over those views) is within `depth_thre` of the view's own
    (normalised over the view). Stage 1 feeds it log depths."""
    v, h, w = depth.shape

    def norm(d):
        return (d - d.min()) / max(d.max() - d.min(), 1e-12)

    masks = np.zeros((v, h, w), bool)
    for i, cur in enumerate(order[1:], 1):
        before = list(order[:i])
        pts = points[before].reshape(-1, 3)
        src, own = norm(depth[before].reshape(-1)), norm(depth[cur])
        pc = pts @ w2cs[cur][:3, :3].T + w2cs[cur][:3, 3]
        uv = pc[:, :2] / np.maximum(pc[:, 2:], 1e-12) * fx + np.array(
            [(w - 1) / 2, (h - 1) / 2])
        ok = (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (
            uv[:, 1] < h)
        xi, yi = uv[ok, 0].astype(int), uv[ok, 1].astype(int)
        hit = np.abs(src[ok] - own[yi, xi]) < depth_thre
        masks[cur, yi[hit], xi[hit]] = True
    return masks


@dataclasses.dataclass
class Geometry:
    """What every seed of a traffic mix shares: the views' true poses and
    the points stage 1 keeps (one a pixel, less the co-visible ones)."""

    n_views: int
    height: int
    width: int
    fx: float
    w2cs: np.ndarray  # [V, 4, 4] true w2c
    points: np.ndarray  # [V, H, W, 3] each pixel's surface point
    keep: np.ndarray  # [V, H, W] bool: the pixels whose points are kept
    xyz: np.ndarray  # [N, 3] float32: the kept pixels' surface points


def geometry(n_views: int, height: int, width: int, arc_rad: float,
             depth_thre: float) -> Geometry:
    """V cameras on an arc of +-arc_rad; each pixel's exact surface point
    and depth; the co-visibility rule over the views in index order."""
    fx = FOCAL_SHARE * width
    angles = (np.linspace(-arc_rad, arc_rad, n_views) if n_views > 1
              else np.zeros(1))
    w2cs = np.stack([look_at_w2c((DIST * np.sin(a), HEIGHT_ABOVE,
                                  -DIST * np.cos(a))) for a in angles])
    cast = [ray_cast(m, fx, height, width) for m in w2cs]
    points = np.stack([p for p, _ in cast])
    depth = np.stack([d for _, d in cast])
    keep = ~co_visible(np.arange(n_views), np.log(depth), points, fx, w2cs,
                       depth_thre)
    return Geometry(n_views=n_views, height=height, width=width, fx=fx,
                    w2cs=w2cs, points=points, keep=keep,
                    xyz=points[keep].astype(np.float32))


def rotmat_to_qvec(R) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    R = np.asarray(R, np.float64)
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[1, 0] + R[0, 1], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[2, 0] + R[0, 2], R[2, 1] + R[1, 2], R[2, 2] - R[0, 0] - R[1, 1],
         0],
        [R[1, 2] - R[2, 1], R[2, 0] - R[0, 2], R[0, 1] - R[1, 0],
         R[0, 0] + R[1, 1] + R[2, 2]]]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def qvec_to_rotmat(q) -> np.ndarray:
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _turned(w2c, rng):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    half = POSE_JITTER_RAD / 2
    turn = qvec_to_rotmat(np.concatenate([[np.cos(half)],
                                          np.sin(half) * axis]))
    shift = rng.normal(size=3)
    out = np.array(w2c, np.float64)
    out[:3, :3] = turn @ out[:3, :3]
    out[:3, 3] = turn @ out[:3, 3] + POSE_JITTER_T * shift / np.linalg.norm(
        shift)
    return out


def write_png(path, img: np.ndarray):
    """8-bit RGB [H, W, 3] uint8, filter 0 on every row."""
    h, w, _ = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    Path(path).write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_point_ply(path, xyz: np.ndarray, rgb8: np.ndarray):
    """Binary little-endian ply: float x y z, zero normals, uchar colours."""
    n = len(xyz)
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    for i, k in enumerate("xyz"):
        rec[k] = xyz[:, i]
    for i, k in enumerate(("red", "green", "blue")):
        rec[k] = rgb8[:, i]
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
        + [f"property float {k}" for k in ("x", "y", "z", "nx", "ny", "nz")]
        + [f"property uchar {k}" for k in ("red", "green", "blue")]
        + ["end_header\n"])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rec.tofile(f)


@dataclasses.dataclass
class Scene:
    """What a scene folder holds, as written (the reference's inputs)."""

    root: Path
    n_views: int
    height: int
    width: int
    fx: float
    names: list  # image file names, sorted
    images: np.ndarray  # [V, H, W, 3] uint8
    qvecs: np.ndarray  # [V, 4] float64, as written (w >= 0)
    tvecs: np.ndarray  # [V, 3] float64, as written
    xyz: np.ndarray  # [N, 3] float32
    rgb8: np.ndarray  # [N, 3] uint8
    confidence: np.ndarray  # [N] float32


def make_scene(root, seed: int, geo: Geometry) -> Scene:
    """Write one scene folder of `geo` under `root` from `seed` (the
    texture's offset, stage 1's pose errors, the confidences); -> its
    Scene."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    shift = rng.uniform(0.0, 8.0, size=2)
    n_views, height, width, fx = geo.n_views, geo.height, geo.width, geo.fx
    sparse = root / f"sparse_{n_views}" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    names, images, qvecs, tvecs = [], [], [], []
    cam_lines, im_lines = [], []
    for k, (truth, p) in enumerate(zip(geo.w2cs, geo.points)):
        img = np.clip(texture(p[..., 0] + shift[0], p[..., 1] + shift[1])
                      * 255.0 + 0.5, 0, 255).astype(np.uint8)
        name = f"{k:03d}.png"
        write_png(root / "images" / name, img)
        pose = _turned(truth, rng)
        q, t = rotmat_to_qvec(pose[:3, :3]), pose[:3, 3]
        names.append(name)
        images.append(img)
        qvecs.append(q)
        tvecs.append(t)
        cam_lines.append(f"{k + 1} PINHOLE {width} {height} {fx!r} {fx!r} "
                         f"{width / 2!r} {height / 2!r}")
        im_lines.append(" ".join([str(k + 1)] + [repr(float(v)) for v in q]
                                 + [repr(float(v)) for v in t]
                                 + [str(k + 1), name]))
        im_lines.append("")
    images = np.stack(images)
    rgb8 = images[geo.keep]
    confidence = rng.uniform(1.0, 10.0, size=len(geo.xyz)).astype(
        np.float32)
    (sparse / "cameras.txt").write_text("\n".join(cam_lines) + "\n")
    (sparse / "images.txt").write_text("\n".join(im_lines) + "\n")
    write_point_ply(sparse / "points3D.ply", geo.xyz, rgb8)
    np.save(sparse / "confidence_dsp.npy", confidence)
    return Scene(root=root, n_views=n_views, height=height, width=width,
                 fx=float(fx), names=names, images=images,
                 qvecs=np.stack(qvecs), tvecs=np.stack(tvecs), xyz=geo.xyz,
                 rgb8=rgb8, confidence=confidence)
