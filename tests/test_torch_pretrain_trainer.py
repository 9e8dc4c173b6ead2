"""The port's pre-training trainer (train_dust3r/trainer.py,
models.mast3r.build_trainable, convert.mast3r_to_numpy) against the JAX
package's on the CPU, with cli/pretrain.py's TINY MASt3R at 32x48 and
`random:0` weights, under the MASt3R fine-tuning loss with seeded GT
correspondences:

- a 3-step float32 trajectory (loss, details and every parameter), each
  step accumulating two micro-batches, against JAX's jitted step with its
  in-jit accumulation, within 1e-4 relative (relative L2 per parameter);
  the port's accumulation of one micro-batch twice is a plain step (the
  plain float32 step is held to JAX's through `cli.pretrain` in
  tests/test_torch_pretrain_data.py, the bf16 step in
  tests/test_torch_pretrain_losses.py);
- checkpoints both ways: JAX writes after two steps and the port resumes,
  the port writes and JAX resumes; each continues to JAX's third step
  within 1e-4; the moments and the step survive exactly;
- `train_loop`'s `keep_every` files, eval entries, resume skip and
  non-finite abort, and the mesh / FSDP paths raising.

JAX's step is jitted once per configuration in a module fixture (its
compile is most of this file's time).
"""

import dataclasses

import numpy as np
import pytest
import torch

from instantsplat_tpu.models import mast3r as jm
from instantsplat_tpu.train_dust3r import losses as jl
from instantsplat_tpu.train_dust3r import trainer as jt
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.cli.pretrain import TINY as TINY_KW
from instantsplat_tpu_torch.models import mast3r as tm
from instantsplat_tpu_torch.train_dust3r import losses as tl
from instantsplat_tpu_torch.train_dust3r import trainer as tt

torch.set_num_threads(2)

TINY = tm.MASt3RConfig(**TINY_KW)
JTINY = jm.MASt3RConfig(**dataclasses.asdict(TINY))
H, W = 32, 48
HYPER = dict(base_lr=5e-4, min_lr=1e-6, warmup_steps=1, total_steps=4,
             weight_decay=0.05)
RTOL = 1e-4
# XLA:CPU at backend optimisation level 0 compiles the TINY step ~25%
# faster; it changes no HLO, only how the CPU code is generated
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def batch_np(seed, n_corres=24):
    """tt.synthetic_batch's draws plus seeded GT correspondences (numpy)."""
    b = tt.synthetic_batch(TINY, batch=2, h=H, w=W, seed=seed)
    out = {k: (v.numpy() if torch.is_tensor(v) else
               {kk: vv.numpy() for kk, vv in v.items()})
           for k, v in b.items()}
    rng = np.random.default_rng(100 + seed)
    xy = np.stack([rng.integers(0, W, (2, n_corres)),
                   rng.integers(0, H, (2, n_corres))], -1).astype(np.int32)
    out["gt1"]["corres"] = xy
    out["gt2"]["corres"] = np.clip(xy + rng.integers(-2, 3, xy.shape),
                                   0, [W - 1, H - 1]).astype(np.int32)
    out["gt1"]["valid_corres"] = rng.random((2, n_corres)) < 0.8
    return out


def to_torch(b):
    return {k: torch.from_numpy(np.asarray(v)) if not isinstance(v, dict)
            else to_torch(v) for k, v in b.items()}


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves(x, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


def assert_tree_close(got, want, tol=RTOL, what=""):
    """Every leaf within `tol` relative L2. Not max-abs per leaf: a
    parameter whose gradient is ~1e-6 (the key biases) gets an Adam step
    that magnifies float32 rounding (ROADMAP.md §3), up to 1.1e-4 of its
    leaf's largest entry after two steps while its relative L2 stays at
    1.1e-5."""
    g, w = dict(leaves(got)), dict(leaves(want))
    assert g.keys() == w.keys(), what
    for k in w:
        scale = max(float(np.linalg.norm(w[k])), 1e-6)
        err = float(np.linalg.norm(g[k] - w[k])) / scale
        assert err <= tol, f"{what}{k}: {err:.3e} > {tol:g}"


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)


def jax_step(accum_iter=1, compute_dtype=None):
    init, step, _ = jt.make_dp_train_step(
        JTINY, loss_fn=jl.mast3r_finetune_loss, accum_iter=accum_iter,
        compute_dtype=compute_dtype, **HYPER)
    return init, step


def compiled(step, state, batch):
    return step.lower(state, batch).compile(compiler_options=FAST_COMPILE)


def port_state(accum_iter=1, compute_dtype=None):
    model = tm.build_trainable("random:0", TINY, device="cpu")
    init, step, _ = tt.make_dp_train_step(
        TINY, loss_fn=tl.mast3r_finetune_loss, accum_iter=accum_iter,
        compute_dtype=compute_dtype, **HYPER)
    return init(model), step


def port_params_tree(state):
    return convert.mast3r_to_numpy(state["params"])


@pytest.fixture(scope="module")
def trajectory():
    """JAX's and the port's 3-step float32 trajectories, each step
    accumulating two micro-batches (batches 0-5): JAX states and metrics
    after each step, the port's parameter trees and metrics, the compiled
    JAX step."""
    micro = [batch_np(s) for s in range(6)]
    batches = [jt.stack_microbatches(micro[2 * i:2 * i + 2])
               for i in range(3)]
    init, step = jax_step(accum_iter=2)
    state = init(jm.init_params(JTINY, seed=0))
    step_c = compiled(step, state, batches[0])
    j_states, j_metrics = [], []
    for b in batches:
        state, met = step_c(state, b)
        j_states.append(state)
        j_metrics.append({k: float(v) for k, v in met.items()})

    pstate, pstep = port_state(accum_iter=2)
    p_trees, p_metrics = [], []
    for i in range(3):
        pstate, met = pstep(pstate, port_batch(micro[2 * i:2 * i + 2]))
        p_trees.append(port_params_tree(pstate))
        p_metrics.append({k: float(v) for k, v in met.items()})
    return dict(micro=micro, batches=batches, j_states=j_states,
                j_metrics=j_metrics, p_trees=p_trees, p_metrics=p_metrics,
                step=step_c)


def port_batch(micro):
    return tt.stack_microbatches([to_torch(b) for b in micro])


def test_three_step_float32_trajectory_matches_jax(trajectory):
    for i in range(3):
        jm_, pm = trajectory["j_metrics"][i], trajectory["p_metrics"][i]
        assert jm_.keys() == pm.keys()
        for k in jm_:
            assert rel(pm[k], jm_[k]) <= RTOL, (i, k, pm[k], jm_[k])
        assert_tree_close(trajectory["p_trees"][i],
                          trajectory["j_states"][i]["params"],
                          what=f"step {i + 1}")
    # the trajectory moved: Adam's first step changes every trained leaf
    moved = trajectory["p_trees"][2]["enc_blocks"][0]["attn"]["qkv"]["w"]
    start = tm.init_params_numpy(TINY, 0)["enc_blocks"][0]["attn"]["qkv"]
    assert np.abs(moved - start["w"]).max() > 1e-4


def test_lr_schedule_is_jax_float32():
    sj = jt.cosine_warmup_schedule(5e-4, 1e-6, 3, 20)
    st = tt.cosine_warmup_schedule(5e-4, 1e-6, 3, 20)
    for s in (0, 1, 2, 3, 4, 11, 19, 20, 25):
        assert st(s) == pytest.approx(float(sj(s)), rel=1e-6, abs=1e-12)


def test_accumulation_is_the_mean_of_the_micro_batches():
    """accum_iter=2 over the same micro-batch twice is one plain step on
    it (JAX's own law, tests/test_pretrain.py)."""
    b = to_torch(batch_np(0))
    one, step1 = port_state()
    one, m1 = step1(one, b)
    two, step2 = port_state(accum_iter=2)
    two, m2 = step2(two, tt.stack_microbatches([b, b]))
    assert rel(m2["loss"], m1["loss"]) <= 1e-6
    assert_tree_close(port_params_tree(two), port_params_tree(one),
                      tol=1e-5)


def test_checkpoint_written_by_jax_resumes_in_the_port(trajectory, tmp_path):
    path = tmp_path / "checkpoint-last.npz"
    jt.save_pretrain_checkpoint(str(path), trajectory["j_states"][1])
    pstate, pstep = port_state(accum_iter=2)
    tt.load_pretrain_checkpoint(path, pstate)
    assert pstate["step"] == 2
    j2 = trajectory["j_states"][1]
    for group in ("params", "m", "v"):
        tree = convert.mast3r_to_numpy(pstate[group])
        for k, want in leaves(j2[group]):
            np.testing.assert_array_equal(dict(leaves(tree))[k], want,
                                          err_msg=f"{group}{k}")
    pstate, met = pstep(pstate, port_batch(trajectory["micro"][4:]))
    assert pstate["step"] == 3
    assert rel(met["loss"], trajectory["j_metrics"][2]["loss"]) <= RTOL
    assert_tree_close(port_params_tree(pstate),
                      trajectory["j_states"][2]["params"],
                      what="resumed in the port ")


def test_checkpoint_written_by_the_port_resumes_in_jax(trajectory,
                                                       tmp_path):
    pstate, pstep = port_state(accum_iter=2)
    for i in range(2):
        pstate, _ = pstep(pstate, port_batch(trajectory["micro"][2 * i:
                                                               2 * i + 2]))
    path = tmp_path / "checkpoint-last.npz"
    tt.save_pretrain_checkpoint(path, pstate)
    assert not (tmp_path / "checkpoint-last.npz.tmp.npz").exists()
    with np.load(path) as z:
        assert "['params']['enc_blocks'][0]['attn']['qkv']['w']" in z.files
        assert int(z["['step']"]) == 2 and z["['step']"].dtype == np.int32

    init, _ = jax_step(accum_iter=2)
    template = init(jm.init_params(JTINY, seed=1))
    state = jt.load_pretrain_checkpoint(str(path), template)
    assert int(state["step"]) == 2
    state, met = trajectory["step"](state, trajectory["batches"][2])
    assert rel(met["loss"], trajectory["j_metrics"][2]["loss"]) <= RTOL
    assert_tree_close(state["params"], trajectory["j_states"][2]["params"],
                      what="resumed in JAX ")


def test_resume_across_the_warmup_boundary(tmp_path):
    """warmup 2: a checkpoint after step 1 loaded into a state whose
    device step counter stands at 4 sets the counter back; steps 2-4 then
    repeat bit for bit, at JAX's float32 rates on both sides of the
    warm-up's end (the step reads them from its device table)."""
    hyper = dict(HYPER, warmup_steps=2, total_steps=6)
    model = tm.build_trainable("random:0", TINY, device="cpu")
    init, step, _ = tt.make_dp_train_step(
        TINY, loss_fn=tl.mast3r_finetune_loss, accum_iter=2, **hyper)
    state = init(model)
    batches = [port_batch([batch_np(2 * i), batch_np(2 * i + 1)])
               for i in range(4)]
    state, _ = step(state, batches[0])
    path = tmp_path / "checkpoint-last.npz"
    tt.save_pretrain_checkpoint(path, state)

    def steps_2_to_4():
        mets = []
        for b in batches[1:]:
            _, met = step(state, b)
            mets.append({k: float(v) for k, v in met.items()})
        return mets, {k: p.detach().clone()
                      for k, p in state["params"].items()}

    first, params = steps_2_to_4()
    assert state["step"] == 4
    tt.load_pretrain_checkpoint(path, state)
    assert state["step"] == 1
    again, params_again = steps_2_to_4()
    assert again == first
    for k in params:
        assert torch.equal(params_again[k], params[k]), k
    sched = jt.cosine_warmup_schedule(hyper["base_lr"], hyper["min_lr"],
                                      2, 6)
    assert [m["lr"] for m in first] == [
        float(np.float32(sched(s))) for s in (2, 3, 4)]


def test_params_only_checkpoint_load(trajectory, tmp_path):
    """The CLI's --pretrained .npz: parameters only, moments untouched."""
    path = tmp_path / "ck.npz"
    jt.save_pretrain_checkpoint(str(path), trajectory["j_states"][0])
    model = tm.build_trainable("random:5", TINY, device="cpu")
    tt.load_pretrain_checkpoint(path, dict(
        params=dict(model.named_parameters())))
    assert_tree_close(convert.mast3r_to_numpy(model.state_dict()),
                      trajectory["j_states"][0]["params"], tol=0.0)


def loop_batches(n):
    return [to_torch(batch_np(s)) for s in range(n)]


def test_train_loop_keep_eval_and_resume(tmp_path):
    kw = dict(HYPER, loss_fn=tl.mast3r_finetune_loss, log_every=2)
    batches = loop_batches(4)
    model = tm.build_trainable("random:0", TINY, device="cpu")
    out = tmp_path / "run"
    _, hist = tt.train_loop(model, TINY, iter(batches), n_steps=4,
                            output_dir=str(out), keep_every=2,
                            eval_batches=lambda: iter(batches[:2]),
                            eval_every=3, **kw)
    assert sorted(p.name for p in out.iterdir()) == [
        "checkpoint-2.npz", "checkpoint-4.npz", "checkpoint-last.npz"]
    train = [s for s, m in hist if "loss" in m]
    evals = [(s, m) for s, m in hist if "test_loss" in m]
    # logged at i % 2 == 0 and the last step, counted from 1
    assert train == [1, 3, 4]
    # every 3 steps and at the end
    assert [s for s, _ in evals] == [3, 4]
    assert {"test_loss", "test_regr3d_1", "test_matching_loss"} <= set(
        evals[0][1])
    # a resumed loop skips the first `step` batches and goes on
    model2 = tm.build_trainable("random:0", TINY, device="cpu")
    _, hist2 = tt.train_loop(model2, TINY, iter(batches + batches[:2]),
                             n_steps=6, output_dir=str(out), **kw)
    assert [s for s, m in hist2 if "loss" in m] == [5, 6]

    # the same six steps without the interruption
    model3 = tm.build_trainable("random:0", TINY, device="cpu")
    _, hist3 = tt.train_loop(model3, TINY, iter(batches + batches[:2]),
                             n_steps=6, **kw)
    for (s2, m2), (s3, m3) in zip(hist2, [h for h in hist3 if h[0] >= 5]):
        assert s2 == s3 and rel(m2["loss"], m3["loss"]) <= 1e-6
    for (n, a), b in zip(model2.named_parameters(), model3.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=n)


def test_nonfinite_loss_aborts():
    batch = to_torch(batch_np(0))
    batch["gt1"]["pts3d"][0, 0, 0, 0] = float("nan")
    model = tm.build_trainable("random:0", TINY, device="cpu")
    with pytest.raises(FloatingPointError):
        tt.train_loop(model, TINY, iter([batch] * 2), n_steps=2,
                      log_every=1, **HYPER)


def test_multi_device_paths_raise():
    """FSDP needs a mesh, as in JAX; a mesh needs the ranks it names (the
    data-parallel steps themselves: tests/test_torch_parallel_pretrain.py)."""
    from instantsplat_tpu_torch.parallel import make_mesh

    model = tm.build_trainable("random:0", TINY, device="cpu")
    with pytest.raises(ValueError, match="needs a mesh"):
        tt.make_dp_train_step(TINY, fsdp=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        tt.train_loop(model, TINY, iter([]), fsdp=True)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tt.make_dp_train_step(TINY, mesh=make_mesh(2))


def test_build_trainable_masters():
    model = tm.build_trainable("random:0", TINY, device="cpu")
    ps = list(model.parameters())
    assert all(p.dtype == torch.float32 and p.requires_grad for p in ps)
    sd = convert.mast3r_from_numpy(tm.init_params_numpy(TINY, 0))
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), sd[n], rtol=0, atol=0)
