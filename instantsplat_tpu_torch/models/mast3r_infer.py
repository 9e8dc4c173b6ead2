"""Batched pairwise MASt3R inference -> PairPrediction for the aligner
(port of instantsplat_tpu/models/mast3r_infer.py).

Two phases, as in the JAX package:

1. encode every unique image ONCE (the reference encodes each image per
   pair, halved by its symmetrization trick, dust3r/model.py:152-169);
2. run the dual decoder + heads over the E directed pairs in batches of
   `batch_size`, gathering the cached encoder tokens per pair; the last
   batch is padded with pair index 0 and the padding dropped.

With a mesh (pair parallelism), the batch is rounded up to a multiple of
the rank count, every rank encodes all images and decodes its contiguous
share of each batch, and the shares are gathered in pair order.

Outputs come back as float32 numpy whatever the model's dtype.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from instantsplat_tpu_torch.init.aligner import PairPrediction
from instantsplat_tpu_torch.models import mast3r


def _device(model):
    return model.decoder_embed.weight.device


def _np(t):
    return t.float().cpu().numpy()


def _decode_share(model, feats, bi, bj, hw, mesh):
    """Decoder + heads of the pairs (bi, bj); with `mesh`, this rank
    decodes its contiguous share and the shares are gathered in order."""
    if mesh is None:
        return model.forward_from_encoded(feats[bi], feats[bj], hw)
    from instantsplat_tpu_torch.parallel import runtime

    group, rank, ndev = runtime.axis(mesh)
    per = bi.shape[0] // ndev
    mine = slice(rank * per, (rank + 1) * per)
    r1, r2 = model.forward_from_encoded(feats[bi[mine]], feats[bj[mine]],
                                        hw)
    return tuple({k: runtime.all_gather_cat(r[k], group)
                  for k in ("pts3d", "conf", "desc")} for r in (r1, r2))


@torch.no_grad()
def infer_pairs(model: mast3r.MASt3R, images, pairs,
                batch_size: int = 8, mesh=None) -> PairPrediction:
    """images [V, H, W, 3] in [0, 1] (or a list of same-shape images);
    pairs: [(i, j)] directed. Mixed shapes go through
    `infer_pairs_mixed`. The returned PairPrediction also carries desc_i /
    desc_j [E, H, W, 24]. `mesh`: decode each batch pair-parallel over
    the ranks of its first axis (the result is the same on every rank)."""
    if isinstance(images, (list, tuple)):
        shapes = {tuple(np.asarray(im).shape[:2]) for im in images}
        if len(shapes) > 1:
            raise TypeError(
                f"infer_pairs got images of mixed shapes {sorted(shapes)}; "
                "its PairPrediction return type holds same-shape stacked "
                "maps. Use models.mast3r_infer.infer_pairs_mixed (returns "
                "one dict per pair, each map in its own image's shape).")
        images = np.stack([np.asarray(im) for im in images])
    images = torch.as_tensor(np.asarray(images, np.float32),
                             device=_device(model))
    v, h, w, _ = images.shape
    feats, _ = model.encode(images)

    e = len(pairs)
    batch_size = max(1, min(batch_size, e))
    if mesh is not None:
        # a multiple of the rank count (small scenes pad up to it)
        ndev = mesh.mesh.numel()  # its one axis
        batch_size = max(ndev, -(-batch_size // ndev) * ndev)
    n_pad = -(-e // batch_size) * batch_size
    ei = np.pad(np.array([i for i, _ in pairs]), (0, n_pad - e))
    ej = np.pad(np.array([j for _, j in pairs]), (0, n_pad - e))
    ldim = model.cfg.local_feat_dim
    out = dict(pred_i=np.empty((e, h, w, 3), np.float32),
               pred_j=np.empty((e, h, w, 3), np.float32),
               conf_i=np.empty((e, h, w), np.float32),
               conf_j=np.empty((e, h, w), np.float32),
               desc_i=np.empty((e, h, w, ldim), np.float32),
               desc_j=np.empty((e, h, w, ldim), np.float32))
    for s in range(0, n_pad, batch_size):
        bi = torch.as_tensor(ei[s:s + batch_size], device=feats.device)
        bj = torch.as_tensor(ej[s:s + batch_size], device=feats.device)
        r1, r2 = _decode_share(model, feats, bi, bj, (h, w), mesh)
        n = min(batch_size, e - s)
        for side, r in (("i", r1), ("j", r2)):
            out[f"pred_{side}"][s:s + n] = _np(r["pts3d"][:n])
            out[f"conf_{side}"][s:s + n] = _np(r["conf"][:n])
            out[f"desc_{side}"][s:s + n] = _np(r["desc"][:n])

    pred = PairPrediction(edges=[tuple(p) for p in pairs],
                          pred_i=out["pred_i"], pred_j=out["pred_j"],
                          conf_i=out["conf_i"], conf_j=out["conf_j"])
    pred.desc_i, pred.desc_j = out["desc_i"], out["desc_j"]
    return pred


@torch.no_grad()
def infer_pairs_mixed(model: mast3r.MASt3R, images, pairs,
                      batch_size: int = 8):
    """Pairwise inference over a MIXED-shape image set: images grouped by
    shape and each group encoded as one batch; directed pairs grouped by
    their (shape_i, shape_j) signature and decoded in batches (the last
    one padded with the chunk's first pair). Portrait images run in their
    true orientation.

    -> list (len == len(pairs)) of dicts with keys pred_i, pred_j,
    conf_i, conf_j, desc_i, desc_j, each map in its own image's shape."""
    dev = _device(model)
    shapes = [tuple(np.asarray(im).shape[:2]) for im in images]
    feats: list = [None] * len(images)
    img_groups = defaultdict(list)
    for idx, s in enumerate(shapes):
        img_groups[s].append(idx)
    for idxs in img_groups.values():
        batch = torch.as_tensor(
            np.stack([np.asarray(images[i], np.float32) for i in idxs]),
            device=dev)
        f, _ = model.encode(batch)
        for k, i in enumerate(idxs):
            feats[i] = f[k]

    edge_groups = defaultdict(list)
    for e, (i, j) in enumerate(pairs):
        edge_groups[(shapes[i], shapes[j])].append(e)

    results: list = [None] * len(pairs)
    for (si, sj), eidx in edge_groups.items():
        bs = min(batch_size, len(eidx))
        for s0 in range(0, len(eidx), bs):
            chunk = eidx[s0:s0 + bs]
            sel = chunk + [chunk[0]] * (bs - len(chunk))
            f1 = torch.stack([feats[pairs[e][0]] for e in sel])
            f2 = torch.stack([feats[pairs[e][1]] for e in sel])
            r1, r2 = model.forward_from_encoded(f1, f2, si, sj)
            for k, e in enumerate(chunk):
                results[e] = dict(
                    pred_i=_np(r1["pts3d"][k]), pred_j=_np(r2["pts3d"][k]),
                    conf_i=_np(r1["conf"][k]), conf_j=_np(r2["conf"][k]),
                    desc_i=_np(r1["desc"][k]), desc_j=_np(r2["desc"][k]))
    return results


def make_pointmap_fn(ckpt_path: str, batch_size: int = 8,
                     cfg: mast3r.MASt3RConfig | None = None, mesh=None,
                     dtype=None, device="cuda"):
    """-> pointmap_fn(images, pairs) for pipelines.init_geo_pipeline.

    ckpt_path: an upstream MASt3R .pth, or "random" / "random:SEED" for the
    full production architecture with the JAX package's random weights
    of that seed (the production compute, garbage geometry).
    dtype: torch.bfloat16 for mixed precision, None for float32.
    mesh: pair-parallel decoding of same-shape scenes over its ranks
    (mixed-shape scenes decode on every rank)."""
    cfg = cfg or mast3r.MASt3RConfig()
    if not ckpt_path:
        raise RuntimeError(
            "init_geo needs a MASt3R checkpoint (--ckpt_path). This "
            "environment ships no pretrained weights; point --ckpt_path at "
            "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth (converted "
            "on load), pass --ckpt_path random for a random-weight "
            "benchmarking run, or initialize the scene with an externally "
            "produced sparse_{n} directory.")
    model = mast3r.build_model(ckpt_path, cfg, device=device, dtype=dtype)

    def fn(images, pairs):
        if isinstance(images, (list, tuple)) and len(
                {np.asarray(im).shape[:2] for im in images}) > 1:
            results = infer_pairs_mixed(model, images, pairs,
                                        batch_size=batch_size)
            shapes = np.array([np.asarray(im).shape[:2] for im in images])
            return mixed_results_to_prediction(results, pairs, shapes)
        return infer_pairs(model, np.asarray(images), pairs,
                           batch_size=batch_size, mesh=mesh)

    return fn


def mixed_results_to_prediction(results, pairs, shapes):
    """infer_pairs_mixed's per-pair maps -> a canvas-padded PairPrediction:
    maps at the top-left of a (Hmax, Wmax) canvas, confidence padding 1.0
    (zero log-conf loss weight, see PairPrediction.shapes)."""
    from instantsplat_tpu_torch.data.images import pad_to_canvas

    shapes = np.asarray(shapes)
    canvas = (int(shapes[:, 0].max()), int(shapes[:, 1].max()))
    return PairPrediction(
        edges=[tuple(p) for p in pairs],
        pred_i=pad_to_canvas([r["pred_i"] for r in results], canvas),
        pred_j=pad_to_canvas([r["pred_j"] for r in results], canvas),
        conf_i=pad_to_canvas([r["conf_i"] for r in results], canvas,
                             fill=1.0),
        conf_j=pad_to_canvas([r["conf_j"] for r in results], canvas,
                             fill=1.0),
        shapes=shapes)
