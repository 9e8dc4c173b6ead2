"""COLMAP SQLite database export (port of instantsplat_tpu/data/colmap_db.py:
the same stdlib sqlite3 writer, copied).

Role of mast3r/colmap/database.py: feed MASt3R keypoints/matches and
camera priors into a COLMAP database so standard SfM tooling
(mapper/triangulator) can consume them. This is a self-contained writer
for the public COLMAP database schema (cameras, images, keypoints,
descriptors, matches, two_view_geometries) using stdlib sqlite3.

Pair ids follow COLMAP's convention:
  pair_id = image_id1 * 2147483647 + image_id2, with image_id1 < image_id2
  (swapped matches are flipped accordingly).
"""

from __future__ import annotations

import sqlite3

import numpy as np

from instantsplat_tpu_torch.utils.transforms import rotmat_to_qvec

MAX_IMAGE_ID = 2147483647

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL,
    width INTEGER NOT NULL,
    height INTEGER NOT NULL,
    params BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""

CAMERA_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1}


def pair_id_from_images(image_id1, image_id2):
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


class ColmapDatabase:
    def __init__(self, path):
        self.conn = sqlite3.connect(str(path))
        self.conn.executescript(_SCHEMA)

    def add_camera(self, model, width, height, params,
                   prior_focal_length=True):
        cur = self.conn.execute(
            "INSERT INTO cameras (model, width, height, params, "
            "prior_focal_length) VALUES (?, ?, ?, ?, ?)",
            (CAMERA_MODEL_IDS[model], int(width), int(height),
             np.asarray(params, np.float64).tobytes(),
             int(prior_focal_length)),
        )
        return cur.lastrowid

    def add_image(self, name, camera_id, prior_q=None, prior_t=None):
        q = [None] * 4 if prior_q is None else [float(v) for v in prior_q]
        t = [None] * 3 if prior_t is None else [float(v) for v in prior_t]
        cur = self.conn.execute(
            "INSERT INTO images (name, camera_id, prior_qw, prior_qx, "
            "prior_qy, prior_qz, prior_tx, prior_ty, prior_tz) "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (name, camera_id, *q, *t),
        )
        return cur.lastrowid

    def add_keypoints(self, image_id, xy):
        kp = np.asarray(xy, np.float32).reshape(-1, 2)
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], 2, kp.tobytes()),
        )

    def add_descriptors(self, image_id, desc):
        d = np.ascontiguousarray(desc, np.uint8)
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, d.shape[0], d.shape[1], d.tobytes()),
        )

    def add_matches(self, image_id1, image_id2, idx_pairs):
        m = np.asarray(idx_pairs, np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pair_id_from_images(image_id1, image_id2), m.shape[0], 2,
             np.ascontiguousarray(m).tobytes()),
        )

    def add_two_view_geometry(self, image_id1, image_id2, idx_pairs,
                              config=2):
        m = np.asarray(idx_pairs, np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            m = m[:, ::-1]
        eye = np.eye(3, dtype=np.float64).tobytes()
        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries "
            "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (pair_id_from_images(image_id1, image_id2), m.shape[0], 2,
             np.ascontiguousarray(m).tobytes(), config, eye, eye, eye,
             np.zeros(4).tobytes(), np.zeros(3).tobytes()),
        )

    def commit(self):
        self.conn.commit()

    def close(self):
        self.conn.commit()
        self.conn.close()


def export_matches_to_colmap_db(
    path, image_names, image_hw, focals, matches_per_edge, edges,
    w2c_priors=None,
):
    """Write a COLMAP DB from per-edge reciprocal matches.

    matches_per_edge: [(xy1 [M,2], xy2 [M,2])] per directed edge (i, j)
    (pixel coords, as produced by ops/matching.fast_reciprocal_nns / the
    sparse aligner). Undirected duplicates are merged by pair id.
    Returns the image_id list.
    """
    db = ColmapDatabase(path)
    h, w = image_hw
    image_ids = []
    keypoints = [dict() for _ in image_names]  # (x, y) -> index

    def kp_index(img, xy):
        key = (int(xy[0]), int(xy[1]))
        d = keypoints[img]
        if key not in d:
            d[key] = len(d)
        return d[key]

    # first pass: assign keypoint indices per image from all matches
    edge_idx_pairs = []
    for (i, j), (xy1, xy2) in zip(edges, matches_per_edge):
        pairs = np.array([
            [kp_index(i, a), kp_index(j, b)] for a, b in zip(xy1, xy2)
        ], np.uint32).reshape(-1, 2)
        edge_idx_pairs.append(pairs)

    for n, name in enumerate(image_names):
        f = float(np.asarray(focals).ravel()[min(
            n, np.asarray(focals).size - 1)])
        cam_id = db.add_camera("PINHOLE", w, h,
                               [f, f, w / 2.0, h / 2.0])
        q = t = None
        if w2c_priors is not None:
            q = rotmat_to_qvec(np.asarray(w2c_priors[n])[:3, :3])
            t = np.asarray(w2c_priors[n])[:3, 3]
        image_ids.append(db.add_image(name, cam_id, q, t))
        kps = sorted(keypoints[n], key=keypoints[n].get)
        db.add_keypoints(image_ids[n],
                         np.array(kps, np.float32).reshape(-1, 2))

    seen = set()
    for (i, j), pairs in zip(edges, edge_idx_pairs):
        pid = pair_id_from_images(image_ids[i], image_ids[j])
        if pid in seen or len(pairs) == 0:
            continue
        seen.add(pid)
        db.add_matches(image_ids[i], image_ids[j], pairs)
        db.add_two_view_geometry(image_ids[i], image_ids[j], pairs)
    db.close()
    return image_ids
