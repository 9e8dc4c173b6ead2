"""DUSt3R/MASt3R pre-training on one device (port of
instantsplat_tpu/train_dust3r/trainer.py).

The model is the port's `MASt3R` module holding float32 master
parameters (`models.mast3r.build_trainable`). One optimizer step is the
JAX package's: forward, loss and backward over `accum_iter` micro-batches
(gradients, loss and details averaged), then AdamW (betas 0.9 / 0.95, eps
1e-8 outside sqrt(v / bc2), bias corrections at the 1-based step, the
cosine-with-warmup learning rate of that step, decoupled weight decay on
parameters with ndim >= 2 only) as a handful of `torch._foreach_*`
launches over all parameters.

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

Data-parallel and fully sharded training over several devices are not
ported yet: `mesh` / `fsdp` raise.
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


def _not_ported(mesh, fsdp):
    if mesh is not None or fsdp:
        raise NotImplementedError(
            "data-parallel / FSDP pre-training over several devices is not "
            "yet ported; run on one device (mesh=None, fsdp=False)")


def _make_objective(cfg, loss_fn, alpha, compute_dtype):
    from torch.func import functional_call

    def objective(model, batch):
        img1, img2 = batch["img1"], batch["img2"]
        if compute_dtype is not None:
            params = {n: p.to(compute_dtype) if p.is_floating_point() else p
                      for n, p in model.named_parameters()}
            r1, r2 = functional_call(
                model, params, (img1.to(compute_dtype),
                                img2.to(compute_dtype)))
        else:
            r1, r2 = model(img1, img2)
        r2 = dict(r2)
        r2["pts3d_in_other_view"] = r2.pop("pts3d")
        loss, details = loss_fn(batch["gt1"], batch["gt2"], r1, r2,
                                alpha=alpha)
        return loss.float(), details

    return objective


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
    metrics = dict(loss, lr, **details) as 0-d tensors (lr a float)."""
    _not_ported(mesh, fsdp)
    lr_sched = cosine_warmup_schedule(base_lr, min_lr, warmup_steps,
                                      total_steps)
    objective = _make_objective(cfg, loss_fn or regr3d_conf_loss, alpha,
                                compute_dtype)
    eps = 1e-8

    def init_state(model):
        params = dict(model.named_parameters())
        return dict(params=params,
                    m={k: torch.zeros_like(p) for k, p in params.items()},
                    v={k: torch.zeros_like(p) for k, p in params.items()},
                    step=0, module=model)

    def grads(model, batch):
        """Averaged gradients into .grad; -> (loss, details)."""
        for p in model.parameters():
            p.grad = None
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

    def train_step(state, batch):
        model = state["module"]
        dev = next(model.parameters()).device
        loss, details = grads(model, to_device(batch, dev))
        step = state["step"] + 1
        lr = lr_sched(step)
        t = np.float32(step)
        bc1 = float(1 - np.float32(beta1) ** t)
        bc2 = float(1 - np.float32(beta2) ** t)
        names = list(state["params"])
        p = [state["params"][k] for k in names]
        # a parameter the loss does not reach (the local-feature head under
        # regr3d_conf, refinenet4's unused skip unit) has a zero gradient,
        # as in JAX: its moments decay and weight decay still applies
        g = [q.grad if q.grad is not None else torch.zeros_like(q)
             for q in p]
        m = [state["m"][k] for k in names]
        v = [state["v"][k] for k in names]
        with torch.no_grad():
            torch._foreach_mul_(m, beta1)
            torch._foreach_add_(m, g, alpha=1 - beta1)
            torch._foreach_mul_(v, beta2)
            torch._foreach_addcmul_(v, g, g, value=1 - beta2)
            den = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            u = torch._foreach_div(m, bc1)
            torch._foreach_div_(u, den)
            # decoupled weight decay on matrices and conv kernels only
            decay = [i for i, q in enumerate(p) if q.ndim >= 2]
            if weight_decay and decay:
                torch._foreach_add_([u[i] for i in decay],
                                    [p[i] for i in decay],
                                    alpha=weight_decay)
            torch._foreach_add_(p, u, alpha=-lr)
        for q in p:
            q.grad = None
        state["step"] = step
        return state, dict(loss=loss, lr=lr, **details)

    return init_state, train_step, to_device


def make_eval_step(cfg, loss_fn=None, alpha=0.2, compute_dtype=None,
                   **_ignored):
    """No-grad loss evaluation: (model, batch) -> (loss, details). Extra
    kwargs (train_loop's training hyperparameters) are accepted and
    ignored, so one **kw config serves both steps."""
    objective = _make_objective(cfg, loss_fn or regr3d_conf_loss, alpha,
                                compute_dtype)

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


def save_pretrain_checkpoint(path, state):
    """state (params / m / v name -> tensor dicts, step) -> one npz in the
    JAX package's layout; written to a temporary file and renamed, so a
    kill mid-save never corrupts checkpoint-last."""
    flat = {}
    for group in _STATE_GROUPS:
        if group in state:
            tree = convert.mast3r_to_numpy(state[group])
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
    parameters. -> the template state."""
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
            with torch.no_grad():
                for name, t in target.items():
                    t.copy_(sd[name])
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
    save boundaries (a per-step host read would stall the card)."""
    _not_ported(mesh, kw.get("fsdp"))
    init_state, train_step, _ = make_dp_train_step(cfg, mesh=mesh, **kw)
    eval_step = make_eval_step(cfg, **kw) if eval_batches is not None \
        else None

    def run_eval(step):
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
