"""3D scene visualization: pointclouds, RGBD meshes, camera frusta, and the
sky mask of the global aligner (a copy of instantsplat_tpu/eval/viz.py,
which needs no JAX; numpy and scipy.ndimage only).

Dependency-free equivalent of the reference's trimesh-based viz layer
(dust3r/viz.py:119-244 `SceneViz` + `pts3d_to_trimesh` and the demo's
glb export, mast3r/demo.py:65-137 `_convert_scene_output_to_glb`):

- `SceneViz.export_glb`: a self-contained binary glTF 2.0 writer
  (points / lines / triangles primitives with per-vertex colors), byte
  for byte the JAX package's file (its generator string included);
- `SceneViz.export_ply`: colored point dump through data/ply's writer;
- `SceneViz.show`: matplotlib 3D snapshot. matplotlib is imported inside
  it: where it is missing the caller prints that the preview was skipped.
"""

from __future__ import annotations

import json
import struct

import numpy as np

_GLB_MAGIC = 0x46546C67
_MODE_POINTS, _MODE_LINES, _MODE_TRIANGLES = 0, 1, 4
_F32, _U32 = 5126, 5125
_ARRAY_BUF, _ELEMENT_BUF = 34962, 34963


def _cv_hsv_bgr_quirk(img_u8):
    """OpenCV-convention HSV planes (H in [0,180), S/V in [0,255]) of a
    uint8 image whose channels are interpreted as B, G, R — replicating
    the reference's quirk of passing its RGB rasters to
    cv2.COLOR_BGR2HSV (dust3r/viz.py:351): hue is computed with the R
    and B channels swapped, and the downstream "blue sky" threshold
    (hue <= 30) was tuned in that swapped space, so real RGB blue lands
    at hue ~0 and matches."""
    cv_b = img_u8[..., 0].astype(np.float32)
    cv_g = img_u8[..., 1].astype(np.float32)
    cv_r = img_u8[..., 2].astype(np.float32)
    v = np.maximum(np.maximum(cv_r, cv_g), cv_b)
    mn = np.minimum(np.minimum(cv_r, cv_g), cv_b)
    delta = v - mn
    safe = np.maximum(delta, 1e-12)
    s = np.where(v > 0, delta * 255.0 / np.maximum(v, 1e-12), 0.0)
    h = np.where(
        v == cv_r, 60.0 * (cv_g - cv_b) / safe,
        np.where(v == cv_g, 120.0 + 60.0 * (cv_b - cv_r) / safe,
                 240.0 + 60.0 * (cv_r - cv_g) / safe))
    h = np.where(delta > 0, h, 0.0)
    h = np.where(h < 0, h + 360.0, h)
    return (np.round(h / 2.0) % 180, np.round(s), v)


def segment_sky(image):
    """Heuristic sky segmentation (reference dust3r/viz.py:345-389): HSV
    blue + luminous-gray thresholds, 5x5 binary opening, then keep every
    8-connected component at least half the size of the largest. cv2 is
    not a dependency of the package, so the HSV conversion (including
    the reference's RGB-passed-as-BGR channel quirk — see
    _cv_hsv_bgr_quirk) and the component labelling run on
    numpy/scipy.ndimage. Returns a [H, W] bool mask."""
    from scipy import ndimage

    image = np.asarray(image)
    if np.issubdtype(image.dtype, np.floating):
        image = np.uint8(255 * image.clip(min=0, max=1))
    h, s, v = _cv_hsv_bgr_quirk(image)

    # cv2.inRange(hsv, [0, 0, 100], [30, 255, 255])
    mask = (h <= 30) & (v >= 100)
    # luminous gray (viz.py:360-363)
    mask |= (s < 10) & (v > 150)
    mask |= (s < 30) & (v > 180)
    mask |= (s < 50) & (v > 220)

    mask = ndimage.binary_opening(mask, structure=np.ones((5, 5), bool))

    labels, n = ndimage.label(mask, structure=np.ones((3, 3), np.int32))
    if n == 0:
        return np.zeros(mask.shape, bool)
    sizes = np.bincount(labels.ravel())[1:]
    # the reference walks components biggest-first and stops at the first
    # one not larger than half the biggest — with a descending order that
    # is exactly "keep every component > max/2"
    keep = np.flatnonzero(sizes > sizes.max() / 2) + 1
    return np.isin(labels, keep)


def depthmap_to_pts3d(depth, intrinsics, cam2world=None):
    """[H,W] depth + K -> [H,W,3] points (camera frame, or world with
    cam2world), pinhole model (dust3r/utils/geometry.py role)."""
    depth = np.asarray(depth, np.float64)
    K = np.asarray(intrinsics, np.float64)
    h, w = depth.shape
    gx, gy = np.meshgrid(np.arange(w), np.arange(h))
    x = (gx - K[0, 2]) / K[0, 0] * depth
    y = (gy - K[1, 2]) / K[1, 1] * depth
    pts = np.stack([x, y, depth], -1)
    if cam2world is not None:
        m = np.asarray(cam2world, np.float64)
        pts = pts @ m[:3, :3].T + m[:3, 3]
    return pts


def pts3d_to_mesh(img, pts3d, valid=None):
    """Grid-triangulate an RGBD pointmap: 2 triangles per pixel quad,
    vertex-colored, invalid quads dropped (dust3r/viz.py:38-76
    `pts3d_to_trimesh`; backward duplicates omitted — the glb writer marks
    the material double-sided instead of doubling faces).

    -> (vertices [N,3], faces [F,3], vertex_colors [N,3]).
    """
    img = np.asarray(img)
    pts3d = np.asarray(pts3d)
    h, w, _ = img.shape
    if pts3d.shape != (h, w, 3):
        raise ValueError(f"pts3d {pts3d.shape} does not match the image "
                         f"{img.shape}")
    vertices = pts3d.reshape(-1, 3)
    colors = img.reshape(-1, 3).astype(np.float64)
    if colors.max() > 1.5:
        colors = colors / 255.0
    idx = np.arange(h * w).reshape(h, w)
    i1 = idx[:-1, :-1].ravel()
    i2 = idx[:-1, 1:].ravel()
    i3 = idx[1:, :-1].ravel()
    i4 = idx[1:, 1:].ravel()
    faces = np.concatenate(
        [np.c_[i1, i2, i3], np.c_[i2, i4, i3]], axis=0)
    if valid is not None:
        v = np.asarray(valid).ravel()
        faces = faces[v[faces].all(-1)]
    return vertices, faces, colors


def auto_cam_size(im_poses):
    """20% of the max camera-center spread (dust3r/viz.py:115-116)."""
    centers = np.asarray(im_poses)[:, :3, 3]
    d = centers[:, None] - centers[None]
    return float(0.2 * np.sqrt((d**2).sum(-1)).max()) or 0.1


def _frustum_segments(pose_c2w, focal, imsize, cam_size):
    """Camera wireframe: optical center -> 4 image-plane corners + the
    image rectangle (the role of dust3r/viz.py:246-320 add_scene_cam's
    cone mesh, as glTF LINES)."""
    w, h = imsize
    f = float(focal) if focal else 1.1 * min(w, h)
    z = cam_size
    hx, hy = w / (2 * f) * z, h / (2 * f) * z
    c = np.zeros(3)
    corners = np.array([[-hx, -hy, z], [hx, -hy, z],
                        [hx, hy, z], [-hx, hy, z]])
    segs = []
    for k in range(4):
        segs.append([c, corners[k]])
        segs.append([corners[k], corners[(k + 1) % 4]])
    segs = np.asarray(segs, np.float64).reshape(-1, 3)
    m = np.asarray(pose_c2w, np.float64)
    return segs @ m[:3, :3].T + m[:3, 3]


class SceneViz:
    """Collects colored geometry; exports glb / ply / matplotlib PNG."""

    def __init__(self):
        self._objs = []  # (mode, positions [N,3], colors [N,3], faces|None)

    # -- adding geometry ---------------------------------------------------

    def add_pointcloud(self, pts3d, color=(0, 0, 0), mask=None):
        pts = np.asarray(pts3d, np.float64).reshape(-1, 3)
        color = np.asarray(color, np.float64)
        if color.ndim <= 1:
            cols = np.tile(np.atleast_1d(color).reshape(1, 3),
                           (len(pts), 1))
        else:
            cols = color.reshape(-1, 3).astype(np.float64)
        if cols.max(initial=0.0) > 1.5:
            cols = cols / 255.0
        if mask is not None:
            m = np.asarray(mask).ravel().astype(bool)
            pts, cols = pts[m], cols[m]
        keep = np.isfinite(pts).all(-1)
        self._objs.append(
            (_MODE_POINTS, pts[keep], cols[keep], None))
        return self

    def add_rgbd(self, image, depth, intrinsics=None, cam2world=None,
                 zfar=np.inf, mask=None):
        image = np.asarray(image)
        h, w, _ = image.shape
        if intrinsics is None:
            f = max(h, w)
            intrinsics = np.array([[f, 0, w / 2], [0, f, h / 2],
                                   [0, 0, 1]], np.float64)
        pts = depthmap_to_pts3d(depth, intrinsics, cam2world=cam2world)
        keep = (np.asarray(depth) < zfar) if mask is None else mask
        return self.add_pointcloud(pts, image.reshape(-1, 3), mask=keep)

    def add_mesh(self, vertices, faces, colors):
        v = np.asarray(vertices, np.float64).reshape(-1, 3)
        c = np.asarray(colors, np.float64).reshape(-1, 3)
        if c.max(initial=0.0) > 1.5:
            c = c / 255.0
        self._objs.append(
            (_MODE_TRIANGLES, v, c,
             np.asarray(faces, np.uint32).reshape(-1, 3)))
        return self

    def add_camera(self, pose_c2w, focal=None, color=(0, 0, 0),
                   imsize=(4, 3), cam_size=0.03):
        segs = _frustum_segments(pose_c2w, focal, imsize, cam_size)
        cols = np.tile(np.asarray(color, np.float64).reshape(1, 3),
                       (len(segs), 1))
        if cols.max(initial=0.0) > 1.5:
            cols = cols / 255.0
        self._objs.append((_MODE_LINES, segs, cols, None))
        return self

    def add_cameras(self, poses, focals=None, imsizes=None, colors=None,
                    **kw):
        def get(lst, i, default=None):
            if lst is None:
                return default
            return lst[i]

        for i, p in enumerate(np.asarray(poses)):
            self.add_camera(
                p, focal=get(focals, i),
                color=get(colors, i, (0.2, 0.2, 0.8)),
                imsize=get(imsizes, i, (4, 3)), **kw)
        return self

    # -- exporters --------------------------------------------------------

    def export_glb(self, path):
        """Write a binary glTF 2.0 file with one node per added object."""
        buffers = bytearray()
        views, accessors, meshes, nodes = [], [], [], []

        def push(data, target):
            nonlocal buffers
            off = len(buffers)
            buffers += data.tobytes()
            while len(buffers) % 4:
                buffers += b"\0"
            views.append(dict(buffer=0, byteOffset=off,
                              byteLength=data.nbytes, target=target))
            return len(views) - 1

        def acc(data, ctype, atype, target, minmax=False):
            vi = push(data, target)
            a = dict(bufferView=vi, componentType=ctype,
                     count=len(data), type=atype)
            if minmax:
                a["min"] = data.min(0).tolist()
                a["max"] = data.max(0).tolist()
            accessors.append(a)
            return len(accessors) - 1

        for mode, pos, col, faces in self._objs:
            if not len(pos):
                continue
            attrs = dict(
                POSITION=acc(pos.astype(np.float32), _F32, "VEC3",
                             _ARRAY_BUF, minmax=True),
                COLOR_0=acc(np.clip(col, 0, 1).astype(np.float32), _F32,
                            "VEC3", _ARRAY_BUF),
            )
            prim = dict(attributes=attrs, mode=mode, material=0)
            if faces is not None:
                prim["indices"] = acc(
                    faces.astype(np.uint32).ravel().reshape(-1, 1),
                    _U32, "SCALAR", _ELEMENT_BUF)
            meshes.append(dict(primitives=[prim]))
            nodes.append(dict(mesh=len(meshes) - 1))

        gltf = dict(
            # the JAX package's generator string: the two files are equal
            asset=dict(version="2.0", generator="instantsplat_tpu"),
            scene=0,
            scenes=[dict(nodes=list(range(len(nodes))))],
            nodes=nodes,
            meshes=meshes,
            materials=[dict(
                pbrMetallicRoughness=dict(metallicFactor=0.0,
                                          roughnessFactor=1.0),
                doubleSided=True)],
            buffers=[dict(byteLength=len(buffers))],
            bufferViews=views,
            accessors=accessors,
        )
        js = json.dumps(gltf, separators=(",", ":")).encode()
        while len(js) % 4:
            js += b" "
        bin_chunk = bytes(buffers)
        total = 12 + 8 + len(js) + 8 + len(bin_chunk)
        with open(path, "wb") as f:
            f.write(struct.pack("<III", _GLB_MAGIC, 2, total))
            f.write(struct.pack("<II", len(js), 0x4E4F534A))  # JSON
            f.write(js)
            f.write(struct.pack("<II", len(bin_chunk), 0x004E4942))  # BIN
            f.write(bin_chunk)
        return path

    def export_ply(self, path):
        """Colored point dump of every object's vertices."""
        from instantsplat_tpu_torch.data.ply import _write_ply

        parts = [o for o in self._objs if len(o[1])]
        if parts:  # empty scene (or fully masked/NaN-filtered points)
            pos = np.concatenate([o[1] for o in parts])
            col = np.concatenate([o[2] for o in parts])
        else:  # write a valid 0-vertex PLY, like export_glb's empty case
            pos = np.zeros((0, 3), np.float32)
            col = np.zeros((0, 3), np.float32)
        col8 = (np.clip(col, 0, 1) * 255).astype(np.uint8)
        _write_ply(path, [
            ("x", pos[:, 0].astype(np.float32)),
            ("y", pos[:, 1].astype(np.float32)),
            ("z", pos[:, 2].astype(np.float32)),
            ("red", col8[:, 0]), ("green", col8[:, 1]),
            ("blue", col8[:, 2]),
        ])
        return path

    def show(self, path=None, point_size=1.5, max_points=100_000,
             elev=-70, azim=-90):
        """Matplotlib 3D snapshot; saves to `path` when given, else
        returns the figure."""
        import matplotlib

        if path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        rng = np.random.default_rng(0)
        for mode, pos, col, faces in self._objs:
            if not len(pos):
                continue
            if mode == _MODE_LINES:
                for k in range(0, len(pos) - 1, 2):
                    ax.plot(*np.stack([pos[k], pos[k + 1]]).T,
                            color=np.clip(col[k], 0, 1), linewidth=1.0)
            else:
                p, c = pos, np.clip(col, 0, 1)
                if len(p) > max_points:
                    sel = rng.choice(len(p), max_points, replace=False)
                    p, c = p[sel], c[sel]
                ax.scatter(p[:, 0], p[:, 1], p[:, 2], c=c, s=point_size)
        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((1, 1, 1))
        if path is not None:
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig
