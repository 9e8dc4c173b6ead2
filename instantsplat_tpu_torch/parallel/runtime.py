"""Process-group start-up and device meshes on torch.distributed (port of
instantsplat_tpu/parallel/runtime.py).

JAX runs one controller process over every local device; PyTorch runs one
process per device. A process joins its group in one of two ways:

- under `torchrun`, which sets WORLD_SIZE / RANK / LOCAL_RANK (and
  MASTER_ADDR / MASTER_PORT): the group rendezvouses through `env://`;
- spawned by `parallel/launch.py`, which also sets INSTANTSPLAT_TORCH_STORE
  to a file in a temporary directory: the group rendezvouses through that
  FileStore, so concurrent launches never compete for a TCP port.

Rank r computes on `cuda:r` (its LOCAL_RANK) over NCCL, or on the CPU over
gloo. Nothing falls back from one to the other.

Mesh axes keep the JAX package's names:
- "data": batch / pair / view / scene parallelism (outermost);
- "rows": pixel-row sharding inside one render.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

STORE_ENV = "INSTANTSPLAT_TORCH_STORE"


def _backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_runtime(device="cuda", init_method: Optional[str] = None,
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> bool:
    """Join the process group; a no-op when single-process.

    Safe to call from every entry point. The arguments default to the
    launcher's environment (WORLD_SIZE, RANK, LOCAL_RANK and the
    launcher's FileStore, else torchrun's env://). `device` picks NCCL
    ("cuda": rank r then computes on cuda:LOCAL_RANK) or gloo ("cpu").
    Returns True when a multi-process group is (or already was) up."""
    if dist.is_initialized():
        return True
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if init_method is None and world_size <= 1:
        return False  # single process: the common case
    if init_method is None:
        store = os.environ.get(STORE_ENV)
        init_method = f"file://{store}" if store else "env://"
    if torch.device(device).type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs cuda:{local}, but "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        torch.cuda.set_device(local)
    dist.init_process_group(_backend(device), init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """True on the rank that writes artifacts and logs (rank 0)."""
    return rank() == 0


def _device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh_nd(axis_shape: Sequence[int], axis_names: Sequence[str],
                 device_type: Optional[str] = None) -> DeviceMesh:
    """N-D DeviceMesh over the first prod(axis_shape) ranks, row-major: the
    LAST axis varies fastest over the ranks, so neighbouring positions
    along it are neighbouring ranks (on one host under torchrun, NVLink
    peers). Put the axis with the heaviest collectives last. Raises when
    the shape needs more ranks than the group has."""
    total = 1
    for s in axis_shape:
        total *= int(s)
    have = world_size()
    if total > have:
        raise ValueError(f"mesh {tuple(axis_shape)} needs {total} devices, "
                         f"have {have}")
    if not dist.is_initialized():
        raise RuntimeError(
            "a device mesh needs a process group: launch the ranks with "
            "torchrun or parallel.launch, or call initialize_runtime")
    ranks = torch.arange(total).reshape(tuple(int(s) for s in axis_shape))
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(ici_shape: Sequence[int], dcn_shape: Sequence[int],
                     axis_names: Sequence[str],
                     device_type: Optional[str] = None) -> DeviceMesh:
    """2-D (or N-D) mesh over several hosts: axis k has dcn_shape[k] x
    ici_shape[k] ranks, the host (DCN) index outermost. Ranks are numbered
    host by host (torchrun's order), so the ici part of every axis stays
    within one host and only the dcn part crosses hosts.

    Example: 2 hosts of 8 cards, data-parallel across hosts and
    row-sharded within: make_hybrid_mesh((1, 8), (2, 1), ("data", "rows"))."""
    ici = [int(s) for s in ici_shape]
    dcn = [int(s) for s in dcn_shape]
    total = 1
    for a, b in zip(ici, dcn):
        total *= a * b
    have = world_size()
    if total > have:
        raise ValueError(f"hybrid mesh ici {tuple(ici)} x dcn {tuple(dcn)} "
                         f"needs {total} devices, have {have}")
    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs a process group")
    nd = len(ici)
    # [dcn..., ici...] rank blocks, host outermost; interleave each axis's
    # dcn and ici parts, dcn first
    ranks = torch.arange(total).reshape(dcn + ici)
    order = [d for k in range(nd) for d in (k, nd + k)]
    ranks = ranks.permute(order).reshape([a * b for a, b in zip(dcn, ici)])
    return DeviceMesh(device_type or _device_type(), ranks,
                      mesh_dim_names=tuple(axis_names))


def axis(mesh: DeviceMesh, name: Optional[str] = None):
    """(process group, this rank's index, size) of one mesh axis (default:
    the first)."""
    names = mesh.mesh_dim_names
    name = names[0] if name is None else name
    dim = names.index(name)
    return (mesh.get_group(name), mesh.get_local_rank(name),
            int(mesh.mesh.shape[dim]))


def all_reduce_flat(tensors, groups=(None,)):
    """The tensors summed over the ranks of each group in turn, through
    one flat buffer: one all-reduce a group, and every rank gets the same
    bits. -> new tensors, shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    for group in groups:
        dist.all_reduce(flat, group=group)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].view(t.shape))
        k += t.numel()
    return out


def all_gather_cat(x, group=None):
    """Every rank's x (all of one shape), concatenated along axis 0 in rank
    order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def broadcast_object(obj, group=None):
    """Rank 0's `obj` (of `group`) on every rank of the group: how a
    host-side decision (a random view order, a backend pick) is made once
    and shared. A no-op without a group."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]
