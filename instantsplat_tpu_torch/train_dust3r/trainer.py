"""DUSt3R/MASt3R pre-training on one device or data parallel over a mesh
(port of instantsplat_tpu/train_dust3r/trainer.py).

The model is the port's `MASt3R` module holding float32 master
parameters (`models.mast3r.build_trainable`). One optimizer step is the
JAX package's: forward, loss and backward over `accum_iter` micro-batches
(gradients, loss and details averaged), then AdamW (betas 0.9 / 0.95, eps
1e-8 outside sqrt(v / bc2), bias corrections at the 1-based step, the
cosine-with-warmup learning rate of that step, decoupled weight decay on
parameters with ndim >= 2 only) as a handful of `torch._foreach_*`
launches over all parameters.

JAX jits the whole step: the micro-batch `lax.scan`, the learning rate of
the step and AdamW. Here the step (every micro-batch's forward and
backward, the accumulation into static gradient buffers, the data-parallel
all-reduce, AdamW) is one `utils/cuda_graphs.StepLoop` per batch shape: on
a card each optimizer step is one replay of a captured CUDA graph, which
reads the batch from static device buffers (filled from pinned memory
before the replay) and the step's learning rate and bias corrections from
a device table by a device step counter; on the CPU the same step runs
eagerly. FSDP takes the same path: its collectives read and write static
buffers (see below), so they are captured with the step.

Mixed precision (`compute_dtype=torch.bfloat16`) is the JAX package's:
every floating parameter (LayerNorm included) and both images are cast to
bf16 for the forward and backward (`torch.func.functional_call` on bf16
copies of the masters, so the gradients reach the float32 masters), and
the loss comes back in float32. Masters, gradients and Adam moments stay
float32; bf16 has float32's exponent range, so there is no loss scaler.

Checkpoints are the JAX package's npz layout: `keystr` paths of the JAX
parameter tree (`['params']['enc_blocks'][0]['attn']['qkv']['w']`, the
same under `['m']` and `['v']`, and `['step']`), written with an atomic
rename, so a `checkpoint-last.npz` written by either package resumes in
the other.

Over a 1-D mesh (`mesh=`, parallel.make_mesh) the step is data parallel:
every rank receives the global batch, runs the model on its contiguous
share of the batch axis (the second axis under accumulation), gathers the
predictions of all ranks and computes the loss of the whole batch (the
gather's adjoint hands each rank its own share of the prediction
gradient), so the loss and its masked means are the global batch's, as
under JAX's SPMD. Micro-batches accumulate locally; one reduction per
optimizer step sums the ranks' gradients: an all-reduce (DDP), or with
`fsdp=True` a reduce-scatter onto flat shards. FSDP keeps the float32
masters, their gradients and both AdamW moments as flat per-rank shards
(each parameter cut into `world` contiguous chunks of its flattened
elements; JAX shards each leaf's largest divisible dim, a different
layout with the same numbers). The rank's chunks live in one flat buffer
and the module's full parameters are views into a padded buffer, both
allocated once, so a step's addresses never change: the step
all-gathers the chunks into a [world, C] working buffer and copies each
parameter's columns into its storage, runs the micro-batches, copies
the gradients into such a buffer and reduce-scatters it onto a gradient
shard, which AdamW reads. The working buffers, the gradients and their
shard are the step's temporaries, as its activations are (a captured
graph gives each a fixed address in its pool, where they share memory
with the activations), so the peak holds what the eager step's did.
Checkpoints stay full tensors in JAX's layout, gathered and written by
rank 0; a resume copies this rank's chunks into the same buffers.
"""

from __future__ import annotations

import math
import os
import re
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.models import mast3r
from instantsplat_tpu_torch.train_dust3r.losses import regr3d_conf_loss
from instantsplat_tpu_torch.utils.cuda_graphs import (StaticInputs, StepLoop,
                                                      StepTable)

# captured step graphs kept at once, one per batch signature (shape and
# dtype of every leaf); the least recently used goes first
_MAX_GRAPHS = 4


def cosine_warmup_schedule(base_lr, min_lr, warmup_steps, total_steps):
    """step -> learning rate: linear warmup, then cosine to min_lr; in
    float32 as the JAX package computes it."""
    f = np.float32

    def lr(step):
        step = f(step)
        warm = f(base_lr) * step / f(max(warmup_steps, 1))
        t = (step - f(warmup_steps)) / f(max(total_steps - warmup_steps, 1))
        cos = f(min_lr) + f(base_lr - min_lr) * f(0.5) * (
            f(1) + np.cos(f(math.pi) * np.clip(t, f(0), f(1))))
        return float(warm if step < warmup_steps else cos)

    return lr


def to_device(batch, device):
    """A batch (nested dicts of tensors) on `device`: the single-device
    placement of the JAX package's `shard_batch`."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch.to(device) if torch.is_tensor(batch) else batch


def _micro(batch, i):
    if isinstance(batch, dict):
        return {k: _micro(v, i) for k, v in batch.items()}
    return batch[i] if torch.is_tensor(batch) else batch


class _DataParallel:
    """One rank's side of a data-parallel step over a 1-D mesh; with fsdp,
    also the flat-shard layout of the parameters, gradients and
    moments."""

    def __init__(self, mesh, fsdp: bool):
        from instantsplat_tpu_torch.parallel import runtime

        self.group, self.rank, self.world = runtime.axis(mesh)
        self.fsdp = fsdp
        self.shapes = None  # each parameter's full shape (fsdp: bind)

    # -- the batch and the predictions --
    def share(self, x):
        """This rank's contiguous share of a batch axis-0 tensor."""
        b = x.shape[0]
        if b % self.world:
            raise ValueError(f"batch {b} does not divide the "
                             f"{self.world}-device mesh")
        per = b // self.world
        return x[self.rank * per:(self.rank + 1) * per]

    def gather(self, x):
        """Every rank's share, concatenated in rank order; the adjoint is
        this rank's own share of the cotangent."""
        from instantsplat_tpu_torch.parallel.sharding import _gather

        return _gather(x, self.group, self.rank).flatten(0, 1)

    # -- gradients --
    def broadcast_(self, tensors):
        """Rank 0's values into `tensors` on every rank (one start)."""
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        torch.distributed.broadcast(
            flat, torch.distributed.get_global_rank(self.group, 0),
            group=self.group)
        with torch.no_grad():
            k = 0
            for t in tensors:
                t.copy_(flat[k:k + t.numel()].view(t.shape))
                k += t.numel()

    def all_reduce(self, grads):
        """The ranks' gradients summed, every rank the same bits."""
        from instantsplat_tpu_torch.parallel.runtime import all_reduce_flat

        return all_reduce_flat(grads, [self.group])

    # -- fsdp: flat shards --
    def _chunk(self, numel: int) -> int:
        return -(-numel // self.world)

    def shard(self, full):
        """This rank's chunks of the full tensors, as 1-D tensors."""
        out = []
        for t in full:
            c = self._chunk(t.numel())
            f = torch.nn.functional.pad(t.reshape(-1),
                                        (0, c * self.world - t.numel()))
            out.append(f.view(self.world, c)[self.rank].clone())
        return out

    def _views(self, flat):
        """Each parameter's chunk of a flat [C] buffer."""
        return [flat[k:k + c] for k, c in self._spans]

    def unshard(self, shards):
        """The full tensors from every rank's chunks (all-gather)."""
        from instantsplat_tpu_torch.parallel.runtime import all_gather_cat

        rows = all_gather_cat(torch.cat(shards)[None], self.group)
        return [col.reshape(-1)[:s.numel()].view(s)
                for col, s in zip(self._columns(rows), self.shapes)]

    def bind(self, model):
        """FSDP's static storage, made once: this rank's chunks of the
        module's parameters in one flat buffer, the module's parameters as
        views into a padded buffer (parameter i takes world x C_i
        elements, row r its r-th chunk). The gradients are left to each
        step (see reduce_scatter). -> the master chunks, one view of the
        flat buffer a parameter."""
        params = list(model.parameters())
        self.shapes = [p.shape for p in params]
        w, size = self.world, 0
        kw = dict(dtype=params[0].dtype, device=params[0].device)
        self._spans = []  # (offset, length) of each parameter's chunk
        for p in params:
            self._spans.append((size, self._chunk(p.numel())))
            size += self._spans[-1][1]
        full = torch.zeros(w * size, **kw)
        self.master = torch.empty(size, **kw)
        self._full = []  # each parameter's storage as [world, C_i]
        with torch.no_grad():
            for p, (k, c) in zip(params, self._spans):
                f = full[w * k:w * (k + c)]
                f[:p.numel()].copy_(p.reshape(-1))
                p.data = f[:p.numel()].view(p.shape)
                p.grad = None
                self._full.append(f.view(w, c))
            masters = self._views(self.master)
            torch._foreach_copy_(masters, [f[self.rank] for f in self._full])
        return masters

    def _nccl(self) -> bool:
        return torch.distributed.get_backend(self.group) == "nccl"

    def _columns(self, rows):
        """Each parameter's [world, C_i] columns of a [world, C] buffer."""
        return [rows[:, k:k + c] for k, c in self._spans]

    def gather_params(self):
        """The module's full parameters from every rank's master chunks,
        written into their static storage: an all-gather into a [world, C]
        working buffer, then each parameter's columns."""
        with torch.no_grad():
            rows = self.master.new_empty(self.world, self.master.numel())
            if self._nccl():
                torch.distributed.all_gather_into_tensor(
                    rows.view(-1), self.master, group=self.group)
            else:
                torch.distributed.all_gather(list(rows.unbind(0)),
                                             self.master, group=self.group)
            torch._foreach_copy_(self._full, self._columns(rows))

    def reduce_scatter(self, params):
        """This rank's chunks of the ranks' summed `.grad`s of `params`, in
        a flat gradient shard (views, one a parameter). The gradients, the
        [world, C] working buffer and the shard are the step's temporaries,
        as its activations are (a captured graph gives each a fixed address
        in its pool, where they share memory with the activations): each
        gradient is copied into the working buffer, padded, and dropped; a
        parameter the loss does not reach has none, and its columns stay
        zero."""
        w = self.world
        with torch.no_grad():
            rows = self.master.new_zeros(w, self.master.numel())
            shard = torch.empty_like(self.master)
            for q, col in zip(params, self._columns(rows)):
                if q.grad is not None:
                    g = q.grad.reshape(-1)
                    col.copy_(torch.nn.functional.pad(
                        g, (0, col.numel() - g.numel())).view(col.shape))
                    q.grad = None
            if self._nccl():
                torch.distributed.reduce_scatter_tensor(
                    shard, rows.view(-1), group=self.group)
            else:  # gloo has no reduce-scatter: all-reduce, keep this row
                torch.distributed.all_reduce(rows, group=self.group)
                shard.copy_(rows[self.rank])
        return self._views(shard)


def _make_objective(cfg, loss_fn, alpha, compute_dtype, dp=None):
    from torch.func import functional_call

    def objective(model, batch):
        img1, img2 = batch["img1"], batch["img2"]
        if dp is not None:  # this rank's share of the batch
            img1, img2 = dp.share(img1), dp.share(img2)
        if compute_dtype is not None:
            params = {n: p.to(compute_dtype) if p.is_floating_point() else p
                      for n, p in model.named_parameters()}
            r1, r2 = functional_call(
                model, params, (img1.to(compute_dtype),
                                img2.to(compute_dtype)))
        else:
            r1, r2 = model(img1, img2)
        if dp is not None:  # the whole batch's predictions on every rank
            r1, r2 = ({k: dp.gather(v) for k, v in r.items()}
                      for r in (r1, r2))
        r2 = dict(r2)
        r2["pts3d_in_other_view"] = r2.pop("pts3d")
        loss, details = loss_fn(batch["gt1"], batch["gt2"], r1, r2,
                                alpha=alpha)
        return loss.float(), details

    return objective


def _adamw(p, g, m, v, decay, lr, bc1, bc2, beta1, beta2, eps,
           weight_decay):
    """One AdamW update of the parameter list p in place: a handful of
    `torch._foreach_*` launches over all parameters, JAX's
    p - lr * (u + wd * p). decay[i]: whether p[i] takes weight decay
    (matrices and conv kernels). lr, bc1, bc2: numbers or 0-dim tensors on
    the parameters' device (a captured step's row of its table). g is the
    step's own (the static `.grad`s the next step zeroes, or the reduced
    gradients), dead once the moments are updated: the denominator is
    computed in it."""
    with torch.no_grad():
        torch._foreach_mul_(m, beta1)
        torch._foreach_add_(m, g, alpha=1 - beta1)
        torch._foreach_mul_(v, beta2)
        torch._foreach_addcmul_(v, g, g, value=1 - beta2)
        den = g
        torch._foreach_copy_(den, v)
        torch._foreach_div_(den, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        u = torch._foreach_div(m, bc1)
        torch._foreach_div_(u, den)
        idx = [i for i, d in enumerate(decay) if d]
        if weight_decay and idx:
            torch._foreach_add_([u[i] for i in idx], [p[i] for i in idx],
                                alpha=weight_decay)
        torch._foreach_mul_(u, lr)
        torch._foreach_sub_(p, u)


def make_dp_train_step(
    cfg: mast3r.MASt3RConfig,
    mesh=None,
    base_lr=1e-4,
    min_lr=1e-6,
    warmup_steps=100,
    total_steps=10_000,
    weight_decay=0.05,
    beta1=0.9,
    beta2=0.95,
    loss_fn: Optional[Callable] = None,
    alpha=0.2,
    compute_dtype=None,
    accum_iter: int = 1,
    fsdp: bool = False,
):
    """-> (init_state, train_step, to_device).

    init_state(model) -> state dict(params={name: master}, m, v (zeros
    like each master), step=0, module=model). train_step(state, batch) ->
    (state, metrics), updating the masters in place; batch = dict img1 /
    img2 [B,H,W,3], gt1 / gt2 view dicts (losses.regr3d_conf_loss), or
    with accum_iter > 1 the [A, B, ...] stack of `stack_microbatches`.
    metrics = dict(loss, lr, **details) as 0-d tensors on the device.

    The step is a StepLoop per batch signature (the module docstring): the
    batch is copied into the loop's static buffers, the device step
    counter is set from state["step"] when the two differ (a resume, a
    checkpoint load), and the step runs (on a card a graph replay). The
    gradients accumulate into static `.grad` buffers that the step zeroes.

    mesh: a 1-D DeviceMesh; every rank passes the same global batch and
    gets the same metrics (see the module docstring). fsdp (needs a
    mesh): params / m / v in the state are this rank's flat chunks, and
    state["dp"] holds the layout and the static buffers; the module's
    parameters hold the full values of the last step's gather."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a mesh")
    dp = None if mesh is None else _DataParallel(mesh, fsdp)
    lr_sched = cosine_warmup_schedule(base_lr, min_lr, warmup_steps,
                                      total_steps)
    objective = _make_objective(cfg, loss_fn or regr3d_conf_loss, alpha,
                                compute_dtype, dp)
    eps = 1e-8

    def init_state(model):
        params = dict(model.named_parameters())
        state = dict(step=0, module=model,
                     decay=[p.ndim >= 2 for p in params.values()])
        if dp is not None:
            dp.broadcast_(list(params.values()))
            state["dp"] = dp
        if fsdp:
            params = dict(zip(params, dp.bind(model)))
        state.update(params=params,
                     m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})
        return state

    def accumulate(model, batch):
        """The step's gradients, this rank's part accumulated into each
        parameter's .grad over the micro-batches (averaged); -> (loss,
        details)."""
        micro = ([batch] if accum_iter == 1 else
                 [_micro(batch, i) for i in range(accum_iter)])
        loss_acc, det_acc = 0.0, {}
        for mb in micro:
            loss, details = objective(model, mb)
            if accum_iter == 1:
                loss.backward()
                return loss.detach(), {k: v.detach()
                                       for k, v in details.items()}
            (loss / accum_iter).backward()
            loss_acc = loss_acc + loss.detach() / accum_iter
            for k, v in details.items():
                det_acc[k] = det_acc.get(k, 0.0) + v.detach() / accum_iter
        return loss_acc, det_acc

    def update(state, model, row):
        """Reduce the ranks' gradients and take AdamW from `row` (lr, bc1,
        bc2 of this step)."""
        names = list(state["params"])
        # a parameter the loss does not reach (the local-feature head under
        # regr3d_conf, refinenet4's unused skip unit) has a zero gradient
        # (its static buffer, zeroed; under fsdp zero columns), as in JAX:
        # its moments decay and weight decay still applies
        g = [q.grad for q in model.parameters()]
        if fsdp:
            g = dp.reduce_scatter(model.parameters())
        elif dp is not None:
            g = dp.all_reduce(g)
        lr, bc1, bc2 = row
        _adamw([state["params"][k] for k in names], g,
               [state["m"][k] for k in names],
               [state["v"][k] for k in names], state["decay"], lr, bc1, bc2,
               beta1, beta2, eps, weight_decay)
        return lr

    def row(step: int):
        """lr, bc1, bc2 of the 1-based `step` in float32, as JAX's step
        computes them on the device."""
        t = np.float32(step)
        return (lr_sched(step), 1 - np.float32(beta1) ** t,
                1 - np.float32(beta2) ** t)

    def rows(n):
        """row() of steps 1..n."""
        return [row(step) for step in range(1, n + 1)]

    sched: dict = {}  # "table": StepTable of rows(n); "at": its counter
    loops: dict = {}  # batch signature and storage -> (StepLoop, inputs)
    pool = []  # the card's graph memory pool, shared by every batch shape

    def table(dev, step: int) -> StepTable:
        """The device table, with a row for `step` (1-based): a longer one
        (and new captures) past its end."""
        tab = sched.get("table")
        if tab is None or step > len(tab):
            n = max(total_steps, warmup_steps, 1)
            while n < step:
                n *= 2
            sched["table"] = tab = StepTable(rows(n), dev)
            sched["at"] = None
            for loop, _ in loops.values():
                loop.reset_graph()
        return tab

    def loop_for(state, batch, dev):
        model = state["module"]
        storage = tuple(t.data_ptr() for group in ("params", "m", "v")
                        for t in state[group].values()) + tuple(
                            q.data_ptr() for q in model.parameters())
        key = (StaticInputs.signature(batch), storage)
        if key in loops:
            loops[key] = loops.pop(key)  # most recently used last
            return loops[key]
        while len(loops) >= _MAX_GRAPHS:  # a stale shape's graph goes
            del loops[next(iter(loops))]
        if dev.type == "cuda" and not pool:
            pool.append(torch.cuda.graph_pool_handle())
        for q in model.parameters():  # static buffers the step zeroes
            if q.grad is None and not fsdp:
                q.grad = torch.zeros_like(q)
        inputs = StaticInputs(batch, dev)
        grads = [q.grad for q in model.parameters()]

        def step():
            if fsdp:
                dp.gather_params()
            else:
                torch._foreach_zero_(grads)
            loss, details = accumulate(model, inputs.tree)
            tab = sched["table"]
            lr = update(state, model, tab.row().unbind(0))
            tab.advance()
            return dict(loss=loss, lr=lr, **details)

        loops[key] = (StepLoop(step, dev, "pretrain step",
                               pool[0] if pool else None,
                               groups=() if dp is None else (dp.group,)),
                      inputs)
        return loops[key]

    def train_step(state, batch):
        model = state["module"]
        step = state["step"] + 1
        dev = next(model.parameters()).device
        tab = table(dev, step)
        loop, inputs = loop_for(state, batch, dev)
        inputs.copy_(batch)
        if sched["at"] != state["step"]:
            tab.seek(state["step"])
        # the outputs of a replay are rewritten by the next one
        metrics = {k: v.clone() for k, v in loop.run(1).items()}
        sched["at"] = step
        state["step"] = step
        return state, metrics

    return init_state, train_step, to_device


def make_eval_step(cfg, loss_fn=None, alpha=0.2, compute_dtype=None,
                   mesh=None, **_ignored):
    """No-grad loss evaluation: (model, batch) -> (loss, details); with
    `mesh` the batch is shared over the ranks as in the training step.
    Extra kwargs (train_loop's training hyperparameters) are accepted and
    ignored, so one **kw config serves both steps."""
    dp = None if mesh is None else _DataParallel(mesh, False)
    objective = _make_objective(cfg, loss_fn or regr3d_conf_loss, alpha,
                                compute_dtype, dp)

    def eval_step(model, batch):
        with torch.no_grad():
            dev = next(model.parameters()).device
            return objective(model, to_device(batch, dev))

    return eval_step


def stack_microbatches(batches):
    """accum_iter loader batches -> one [A, B, ...] batch."""
    first = batches[0]
    if isinstance(first, dict):
        return {k: stack_microbatches([b[k] for b in batches])
                for k in first}
    return torch.stack(batches)


# -- checkpoints: the JAX package's npz layout --------------------------------

_STATE_GROUPS = ("params", "m", "v")


def _flatten(tree, prefix):
    """JAX `keystr` paths of a nested dict/list tree -> leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, x in enumerate(tree):
            yield from _flatten(x, f"{prefix}[{i}]")
    else:
        yield prefix, tree


_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\d+)\]")


def _unflatten(items):
    """(keystr path, leaf) pairs -> nested dicts, lists where the keys are
    indices."""
    root = {}
    for path, leaf in items:
        keys = [k[1:-1] if k.startswith("'") else int(k)
                for k in _KEY.findall(path)]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [lists(node[i]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def _full_groups(state):
    """{group: {name: full tensor}}: an FSDP state's chunks gathered (a
    collective: every rank calls it)."""
    dp = state.get("dp")
    out = {}
    for group in _STATE_GROUPS:
        if group not in state:
            continue
        tensors = state[group]
        if dp is not None and dp.fsdp:
            tensors = dict(zip(tensors, dp.unshard(list(tensors.values()))))
        out[group] = tensors
    return out


def save_pretrain_checkpoint(path, state):
    """state (params / m / v name -> tensor dicts, step) -> one npz in the
    JAX package's layout; written to a temporary file and renamed, so a
    kill mid-save never corrupts checkpoint-last. Under a mesh every rank
    calls it (an FSDP state's chunks are gathered) and rank 0 writes the
    full tensors."""
    full = _full_groups(state)
    dp = state.get("dp")
    if dp is not None and dp.rank != 0:
        return
    flat = {}
    for group, tensors in full.items():
        tree = convert.mast3r_to_numpy(tensors)
        flat.update(_flatten(tree, f"[{group!r}]"))
    flat["['step']"] = np.asarray(int(state["step"]), np.int32)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_pretrain_checkpoint(path, template_state):
    """Inverse of save, for a checkpoint of either package: each group the
    template holds (params / m / v, and step) is read by key path and
    copied into the template's tensors (their device and dtype); a key the
    file lacks raises KeyError. A params-only template reads only the
    parameters. An FSDP template takes this rank's chunks of the full
    tensors (every rank reads the file). -> the template state."""
    dp = template_state.get("dp")
    with np.load(path) as z:
        for group in _STATE_GROUPS:
            if group not in template_state:
                continue
            pre = f"[{group!r}]"
            tree = _unflatten((k[len(pre):], z[k]) for k in z.files
                              if k.startswith(pre))
            if not tree:
                raise KeyError(f"{path} holds no {pre} entries")
            sd = convert.mast3r_from_numpy(tree)
            target = template_state[group]
            missing = sorted(set(target) - set(sd))
            if missing:
                raise KeyError(f"{path} lacks {pre} entries for "
                               f"{missing[:5]}")
            src = [sd[name] for name in target]
            if dp is not None and dp.fsdp:
                dev = next(iter(target.values())).device
                src = dp.shard([x.to(dev) for x in src])
            with torch.no_grad():
                for t, x in zip(target.values(), src):
                    t.copy_(x)
        if "step" in template_state:
            template_state["step"] = int(z["['step']"])
    return template_state


def train_loop(model, cfg, batches: Iterator, mesh=None, n_steps=None,
               log_every=10, output_dir=None, save_every=None,
               keep_every=None, eval_batches=None, eval_every=None, **kw):
    """Train `model` (float32 masters, updated in place) on `batches`;
    -> (model, history).

    With `output_dir`, resumes from `<output_dir>/checkpoint-last.npz`
    when present, skipping the first `step` batches so a deterministic
    batch source reproduces the uninterrupted trajectory, and saves there
    every `save_every` optimizer steps and at the end; `keep_every` also
    writes `checkpoint-{step}.npz`. `eval_batches` (a zero-argument
    callable giving a fresh batch iterator) with `eval_every` runs the
    no-grad test pass every that many steps and at the end, appending
    ``(step, {'test_loss': ...})``. History steps count from 1. A
    non-finite loss raises FloatingPointError, checked at the log and
    save boundaries (a per-step host read would stall the card).

    mesh: data-parallel (and with fsdp=True fully sharded) over a 1-D
    mesh; every rank passes the same batches, rank 0 writes the
    checkpoints, and every rank returns the whole trained model."""
    fsdp = bool(kw.get("fsdp"))
    init_state, train_step, _ = make_dp_train_step(cfg, mesh=mesh, **kw)
    eval_step = make_eval_step(cfg, mesh=mesh, **kw) \
        if eval_batches is not None else None

    def run_eval(step):
        if fsdp:  # the module holds the values before the last update
            state["dp"].gather_params()
        totals, n = {}, 0
        for eb in eval_batches():
            loss, details = eval_step(model, eb)
            totals["test_loss"] = totals.get("test_loss", 0.0) + float(loss)
            for k, v in details.items():
                totals[f"test_{k}"] = totals.get(f"test_{k}", 0.0) \
                    + float(v)
            n += 1
        if n:
            history.append((step, {k: v / n for k, v in totals.items()}))

    state = init_state(model)
    skip = 0
    ckpt_path = None
    if output_dir is not None:
        if mesh is None or state["dp"].rank == 0:
            os.makedirs(output_dir, exist_ok=True)
        ckpt_path = os.path.join(output_dir, "checkpoint-last.npz")
        if os.path.isfile(ckpt_path):
            state = load_pretrain_checkpoint(ckpt_path, state)
            skip = int(state["step"])
    history = []

    def check_finite(metrics):
        loss = float(metrics["loss"])
        if not np.isfinite(loss):
            raise FloatingPointError(f"Loss is {loss}, stopping training")
        return loss

    metrics = None
    last_eval = -1
    for i, batch in enumerate(batches):
        if n_steps is not None and i >= n_steps:
            break
        if i < skip:  # consumed before the resume point
            continue
        state, metrics = train_step(state, batch)
        if i % log_every == 0 or (n_steps and i == n_steps - 1):
            check_finite(metrics)
            history.append(
                (i + 1, {k: float(v) for k, v in metrics.items()}))
        if ckpt_path and save_every and (i + 1) % save_every == 0:
            check_finite(metrics)
            save_pretrain_checkpoint(ckpt_path, state)
        if output_dir and keep_every and (i + 1) % keep_every == 0:
            check_finite(metrics)
            save_pretrain_checkpoint(
                os.path.join(output_dir, f"checkpoint-{i + 1}.npz"), state)
        if eval_step is not None and eval_every and \
                (i + 1) % eval_every == 0:
            run_eval(i + 1)
            last_eval = i + 1
    if ckpt_path is not None and metrics is not None:
        check_finite(metrics)
        save_pretrain_checkpoint(ckpt_path, state)
    if eval_step is not None and metrics is not None and \
            int(state["step"]) != last_eval:
        run_eval(int(state["step"]))
    if fsdp:
        state["dp"].gather_params()
    return model, history


def synthetic_batch(cfg, batch=2, h=32, w=48, seed=0):
    """Geometry-consistent random pre-training batch (torch CPU tensors;
    the JAX package's draws)."""
    rng = np.random.default_rng(seed)
    pts_w = rng.standard_normal((batch, h, w, 3)).astype(np.float32)
    pts_w[..., 2] += 4.0
    pose1 = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    pose2 = pose1.copy()
    pose2[:, 0, 3] = 0.3
    t = torch.from_numpy
    return dict(
        img1=t(rng.random((batch, h, w, 3)).astype(np.float32)),
        img2=t(rng.random((batch, h, w, 3)).astype(np.float32)),
        gt1=dict(pts3d=t(pts_w), camera_pose=t(pose1),
                 valid_mask=torch.ones((batch, h, w), dtype=torch.bool)),
        gt2=dict(pts3d=t(pts_w + 0.1), camera_pose=t(pose2),
                 valid_mask=torch.ones((batch, h, w), dtype=torch.bool)),
    )
