"""Tensor-parallel MASt3R (port of instantsplat_tpu/parallel/tp.py).

Megatron's layout over a "model" mesh axis with
torch.distributed.tensor.parallel: column-parallel up-projections
(attention `qkv`, cross-attention `projq` / `projk` / `projv`, MLP `fc1`)
and row-parallel down-projections (`proj`, `fc2`), whose partial outputs
are all-reduced. Everything else (norms, embeddings, convolutions, the
DPT heads) stays replicated.

The JAX package keeps global semantics (its SPMD partitioner inserts the
collectives); here each rank computes on its own shards with local
tensors, so the shards must be whole attention heads: column-splitting
`qkv`'s 3*D outputs as they lie would give rank 0 all of q and half of k.
The `qkv` rows are therefore permuted to (rank, q|k|v, head, dim) before
the split, so each rank holds q, k and v of its own heads, and each
attention module's head count becomes its local one. A column layer and
its row partner are sharded together or not at all.
"""

from __future__ import annotations

import torch
from torch import nn


def _units(model: nn.Module):
    """(module, column names, row name, heads or None) of every attention,
    cross-attention and MLP unit."""
    from instantsplat_tpu_torch.models import mast3r

    for m in model.modules():
        if isinstance(m, mast3r.Attention):
            yield m, ("qkv",), "proj", m.n_heads
        elif isinstance(m, mast3r.CrossAttention):
            yield m, ("projq", "projk", "projv"), "proj", m.n_heads
        elif isinstance(m, mast3r.Mlp):
            yield m, ("fc1",), "fc2", None


def _permute_qkv(lin: nn.Linear, heads: int, tp: int):
    """Reorder qkv's output rows from (q|k|v, head, dim) to (rank,
    q|k|v, local head, dim): a contiguous split then hands each rank q, k
    and v of heads [r * heads / tp, (r + 1) * heads / tp)."""
    d = lin.out_features // 3
    hd = d // heads
    idx = torch.arange(3 * d).reshape(3, tp, heads // tp, hd)
    idx = idx.permute(1, 0, 2, 3).reshape(-1).to(lin.weight.device)
    with torch.no_grad():
        lin.weight.copy_(lin.weight[idx])
        lin.bias.copy_(lin.bias[idx])


def shard_params_tp(model: nn.Module, mesh, strict: bool = False):
    """Shard a MASt3R module tensor-parallel over the mesh axis "model",
    in place; returns the module.

    A unit is sharded when the axis size divides its column layers'
    output width, its row layer's input width and (for attention) its
    head count; otherwise it stays replicated, or raises with
    strict=True. A degree that divides nothing raises either way."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
        parallelize_module,
    )

    assert "model" in mesh.mesh_dim_names, mesh.mesh_dim_names
    tp_mesh = mesh["model"] if mesh.ndim > 1 else mesh
    n = tp_mesh.size()
    n_sharded = 0
    for unit, cols, row, heads in list(_units(model)):
        widths = [getattr(unit, c).out_features for c in cols]
        widths.append(getattr(unit, row).in_features)
        if heads is not None:
            widths.append(heads)
        if any(w % n for w in widths):
            if strict:
                raise ValueError(
                    f"{type(unit).__name__}: widths {widths} not divisible "
                    f"by TP={n}")
            continue
        if heads is not None:
            if cols == ("qkv",):
                _permute_qkv(unit.qkv, heads, n)
            unit.n_heads = heads // n
        plan = {c: ColwiseParallel() for c in cols}
        plan[row] = RowwiseParallel()
        parallelize_module(unit, tp_mesh, plan)
        n_sharded += 1
    if n_sharded == 0:
        raise ValueError(
            f"TP={n} divides no weight dim of this model: every unit would "
            "be replicated. Pick a TP degree dividing the embed/mlp/qkv "
            "dims.")
    return model
