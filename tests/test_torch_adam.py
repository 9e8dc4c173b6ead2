"""Stage 2's fused Adam step (ops/adam.py, csrc/adam.cu) on the CPU:
the kernels' source built for the host (tests/torch_cuda_host.py) against
GaussianOptimizer.apply_step_plain, bit for bit, with and without
pp_optimizer, per-point rates and SH coefficients, on sizes that are not a
multiple of 4, on unaligned gradients, and through the whole-tensor
zero-gradient skip's edges (an all-zero group, squares that underflow, a
NaN, an inf); the wrapper's refusals; and make_train_scan's Adam counters
from a traced block, whose parameters equal the plain step's. No card and
no JAX (test_torch_losses_opt.py holds the plain step to JAX's)."""

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.data.scene import read_scene
from instantsplat_tpu_torch.models.camera import stack_cameras
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.ops import adam
from instantsplat_tpu_torch.opt.gaussian_opt import (GaussianOptimizer,
                                                     OptimizationConfig,
                                                     confidence_to_lr)
from instantsplat_tpu_torch.pipelines import trainer as tr
from instantsplat_tpu_torch.utils import profiling
from torch_cuda_host import host_library, on_host
from torch_scenes import write_tiny_scene

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

N = 501  # Gaussians: xyz holds 1503 floats, not a multiple of 4
STEPS = 3
_SQRT = torch.sqrt


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """torch.sqrt correctly rounded, as the card's torch.sqrt and the
    kernels' __fsqrt_rn take it: PyTorch's vectorised CPU square root is
    not (AVX-512: ~0.6% of float32 inputs an ulp off). Taken in float64
    and rounded once more, it is."""
    return _SQRT(x.double()).to(x.dtype)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return host_library("adam.cu", tmp_path_factory.mktemp("adam_host"))


def _params(rng, rest: int) -> GaussianModel:
    def f(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    return GaussianModel(xyz=f(N, 3), features_dc=f(N, 1, 3),
                         features_rest=f(N, rest, 3), scaling=f(N, 3),
                         rotation=f(N, 4), opacity=f(N, 1),
                         cam_poses=f(3, 7), max_sh_degree=3 if rest else 0)


def _grads(rng, params, fault: str, unaligned: bool) -> dict:
    grads = {}
    for name in PARAM_FIELDS:
        shape = getattr(params, name).shape
        g = torch.tensor(rng.normal(size=shape) * 1e-3, dtype=torch.float32)
        if unaligned:  # one float past a 16-byte boundary
            g = torch.empty(g.numel() + 1)[1:].view(shape).copy_(g)
        grads[name] = g
    if fault == "zero":  # the cells' SH coefficients at degree 0
        grads["features_rest"].zero_()
    elif fault == "underflow":  # every square rounds to 0: skipped
        grads["opacity"].zero_()
        grads["opacity"][::7] = 1e-24
        grads["opacity"][3] = -9e-24
    elif fault == "nan":  # the sum is NaN: skipped
        grads["rotation"][N // 2, 1] = float("nan")
    elif fault == "inf":  # the sum is inf: not skipped
        grads["features_dc"][7, 0, 2] = float("inf")
    return grads


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _skips(grads) -> list:
    """apply_step_plain's rule, per group: sum(g*g) > 0 fails."""
    return [not bool(torch.sum(grads[n] * grads[n]) > 0) for n in PARAM_FIELDS]


CASES = [(pp, rest, ppl, "", False) for pp in (True, False)
         for rest in (15, 0) for ppl in (True, False)] + [
    (True, 15, True, "", True), (True, 15, True, "zero", False),
    (True, 15, True, "underflow", False), (True, 15, False, "nan", False),
    (True, 0, True, "inf", False)]


@pytest.mark.parametrize(
    "pp,rest,ppl,fault,unaligned", CASES,
    ids=[f"{'pp' if c[0] else 'adam'}-sh{c[1]}-{'ppl' if c[2] else 'noppl'}"
         f"{'-' + c[3] if c[3] else ''}{'-unaligned' if c[4] else ''}"
         for c in CASES])
def test_kernel_source_on_the_host_matches_plain(host_lib, monkeypatch, pp,
                                                 rest, ppl, fault, unaligned):
    """STEPS steps of csrc/adam.cu built for the host (fused_step) against
    apply_step_plain from one state with non-zero moments: parameters and
    both moments bit for bit, and the skip table counting each group's
    skipped steps (none without pp_optimizer). The plain step takes its
    square roots correctly rounded (_sqrt_rn), as on the card."""
    on_host(monkeypatch, "adam.cu", host_lib, adam)
    rng = np.random.default_rng([int(pp), rest, int(ppl), len(fault)])
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=pp,
                                               optim_pose=True),
                            total_iterations=50)
    params = _params(rng, rest)
    state = opt.init(params)
    for name in PARAM_FIELDS:
        state.m[name].copy_(torch.tensor(
            rng.normal(size=state.m[name].shape) * 1e-3))
        state.v[name].copy_(torch.tensor(
            rng.uniform(size=state.v[name].shape) * 1e-6))
    state.per_point_lr = (confidence_to_lr(rng.normal(size=N) * 2)
                          .reshape(-1, 1) if ppl else None)
    fused = (GaussianModel(**{n: getattr(params, n).clone()
                              for n in PARAM_FIELDS}, max_sh_degree=0),
             {n: t.clone() for n, t in state.m.items()},
             {n: t.clone() for n, t in state.v.items()})
    skipped = adam.skip_table(params.xyz.device)
    skipped.zero_()
    want = np.zeros(len(PARAM_FIELDS), np.int32)
    table = opt.step_scalars(range(1, STEPS + 1), 1)
    for step in range(STEPS):
        grads = _grads(rng, params, fault, unaligned)
        if pp:
            want += _skips(grads)
        with monkeypatch.context() as patch:
            patch.setattr(torch, "sqrt", _sqrt_rn)
            opt.apply_step_plain(params, grads, state, table[step])
        fused_state = type(state)(m=fused[1], v=fused[2], step=state.step,
                                  per_point_lr=state.per_point_lr)
        adam.fused_step(opt.cfg, fused[0], grads, fused_state, table[step])
    for name in PARAM_FIELDS:
        for what, a, b in (("p", getattr(fused[0], name),
                            getattr(params, name)),
                           ("m", fused[1][name], state.m[name]),
                           ("v", fused[2][name], state.v[name])):
            assert torch.equal(_bits(a), _bits(b)), (what, name)
    assert skipped.tolist() == want.tolist()
    # the groups skipped: the faulty one, and an empty features_rest (a sum
    # over nothing is 0)
    held = {"zero": "features_rest", "underflow": "opacity",
            "nan": "rotation"}.get(fault)
    assert want.tolist() == [STEPS * pp * (
        n == held or (n == "features_rest" and not rest))
        for n in PARAM_FIELDS]
    if fault == "inf":
        assert torch.isnan(params.features_dc[7, 0, 2])


def test_skip_table_is_one_per_device_and_kept(host_lib, monkeypatch):
    """The fused steps of two optimizers on one device count into one skip
    table, which later calls hand back unchanged (a captured step keeps
    pointing at it)."""
    on_host(monkeypatch, "adam.cu", host_lib, adam)
    rng = np.random.default_rng(7)
    table = adam.skip_table("cpu")
    table.zero_()
    for _ in range(2):
        opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True))
        params = _params(rng, 3)
        state = opt.init(params)
        grads = _grads(rng, params, "zero", False)
        adam.fused_step(opt.cfg, params, grads, state,
                        opt.step_scalars([1], 1)[0])
    assert adam.skip_table(torch.device("cpu")) is table
    assert table.tolist() == [2 * (n == "features_rest")
                              for n in PARAM_FIELDS]

def _refusal(case):
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True))
    params = _params(np.random.default_rng(0), 3)
    state = opt.init(params)
    grads = {n: torch.zeros_like(getattr(params, n)) for n in PARAM_FIELDS}
    scalars = opt.step_scalars([1], 1)[0]
    if case == "shape":
        grads["scaling"] = torch.zeros(N, 4)
    elif case == "dtype":
        state.v["opacity"] = state.v["opacity"].double()
    elif case == "contiguity":
        state.m["xyz"] = torch.zeros(3, N).T
    elif case == "scalars":
        scalars = scalars[:-1]
    elif case == "rates":
        state.per_point_lr = torch.ones(N - 1, 1)
    return opt, params, grads, state, scalars


@pytest.mark.parametrize("case,message", [
    ("shape", "gradient of scaling"), ("dtype", "second moment of opacity"),
    ("contiguity", "first moment of xyz is not contiguous"),
    ("scalars", "step's scalars"), ("rates", "per-point rates")])
def test_fused_step_refuses_and_names_the_fault(case, message):
    opt, params, grads, state, scalars = _refusal(case)
    with pytest.raises(ValueError, match=message):
        adam.fused_step(opt.cfg, params, grads, state, scalars)


def _block_run(info, fused: bool, traced: bool, monkeypatch):
    """Two make_train_scan blocks on the tiny scene: 4 iterations at SH
    degree 0, 2 at degree 1, every square root correctly rounded
    (_sqrt_rn); -> (params, state, counters)."""
    monkeypatch.setattr(adam, "serves", lambda t: fused)
    monkeypatch.setattr(torch, "sqrt", _sqrt_rn)
    g = GaussianModel.create_from_pcd(
        info.points, info.colors, max_sh_degree=1, device="cpu",
        cam_poses=GaussianModel.init_cam_poses_from_w2c(info.poses_w2c))
    # anisotropic scales and random rotations: an isotropic Gaussian's
    # covariance does not depend on its rotation (an all-zero gradient)
    gen = torch.Generator().manual_seed(5)
    g.scaling.add_(torch.randn(g.scaling.shape, generator=gen) * 0.3)
    g.rotation.copy_(torch.randn(g.rotation.shape, generator=gen))
    opt = GaussianOptimizer(OptimizationConfig(pp_optimizer=True,
                                               optim_pose=True),
                            spatial_lr_scale=info.nerf_radius,
                            total_iterations=10)
    state = opt.init(g)
    block = tr.make_train_scan(opt, stack_cameras(info.cameras),
                               torch.zeros(3), 0.2, "pallas", 256)
    profiling.reset()
    profiling.enable(traced)
    try:
        block(g, state, [0, 1, 2, 0], [1, 2, 3, 4], 0)
        block(g, state, [1, 2], [5, 6], 1)
        counters = dict(profiling.snapshot()["counters"])
    finally:
        profiling.enable(False)
        profiling.reset()
    return g, state, {k: v for k, v in counters.items()
                      if k.startswith("adam.")}


def test_traced_block_counts_skipped_groups(host_lib, monkeypatch, tmp_path):
    """The kernels built for the host in two traced make_train_scan blocks:
    adam.skipped.features_rest counts the four degree-0 steps (its
    gradient is all zero there) and no degree-1 step, every other group
    counts 0, adam.fused_steps the six steps; untraced, the skip table is
    not read. Parameters and moments equal the plain step's bits."""
    on_host(monkeypatch, "adam.cu", host_lib, adam)
    write_tiny_scene(tmp_path / "scene")
    info = read_scene(tmp_path / "scene", 3, device="cpu")
    g, state, counters = _block_run(info, True, True, monkeypatch)
    assert counters == {"adam.fused_steps": 6, **{
        f"adam.skipped.{n}": 4 * (n == "features_rest")
        for n in PARAM_FIELDS}}
    assert _block_run(info, True, False, monkeypatch)[2] == {
        "adam.fused_steps": 6}
    gp, sp, plain_counters = _block_run(info, False, True, monkeypatch)
    assert plain_counters == {}
    for name in PARAM_FIELDS:
        assert torch.equal(getattr(g, name), getattr(gp, name)), name
        assert torch.equal(state.m[name], sp.m[name]), name
        assert torch.equal(state.v[name], sp.v[name]), name
