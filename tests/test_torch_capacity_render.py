"""The port's binned and tiled composites and their gradients against the
JAX package's Pallas kernels (K3/K4, K5/K6) run in interpret mode on the
CPU, as tests/test_rasterize_pallas.py runs them.

Same seeded numpy splats (2000 at 64x48) into both packages, for a string
sized by the requirements (drop-free) and a deliberately overflowing one:
both drop the same pairs, so the images still agree. Tolerances are the
JAX suite's binned/tiled ones (tests/test_rasterize_pallas.py:155-198,
345-395): rgb and alpha atol 2e-5, depth 2e-4; gradients atol 5e-5
relative to each one's scale. Each JAX value-and-gradient is computed once
per case (interpret mode costs seconds per call).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instantsplat_tpu.ops import rasterize_pallas_binned as jb
from instantsplat_tpu.ops import rasterize_pallas_tiled as jt
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as B
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as T
from test_torch_capacity import cols4, packed_of, random_splats

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

H, W, N = 48, 64, 2000
NAMES = ("mean2d", "conic", "log_op", "colors", "depth", "bg")
# packed columns of each per-splat gradient
COLUMNS = {"mean2d": slice(0, 2), "conic": slice(2, 5), "log_op": 5,
           "colors": slice(6, 9), "depth": 9}


@pytest.fixture(scope="module")
def inputs():
    arrs = random_splats(21, N, H, W)
    rng = np.random.default_rng(22)
    cot = dict(rgb=rng.normal(size=(H, W, 3)), alpha=rng.normal(size=(H, W)),
               depth=rng.normal(size=(H, W)) * 0.1)
    cot = {k: v.astype(np.float32) for k, v in cot.items()}
    return arrs, np.array([0.3, 0.2, 0.1], np.float32), cot


def _caps(kind, arrs):
    """(sized caps, overflowing caps) of a backend for these splats."""
    if kind == "binned":
        return B.bin_requirements(*cols4(arrs, torch.tensor), H, W), (1, 2)
    return T.tile_requirements(*cols4(arrs, torch.tensor), H, W), (1, 1, 1)


def _kw(kind, caps):
    names = (("cap_factor", "d_levels") if kind == "binned" else
             ("cap_factor", "dy_levels", "dx_levels"))
    return dict(zip(names, caps))


CASES = [("binned", "sized"), ("binned", "overflowing"), ("tiled", "sized"),
         ("tiled", "overflowing")]


@pytest.fixture(scope="module")
def results(inputs):
    """{case: (jax out, jax grads, port out, port grads, port overflow)},
    each computed on first use."""
    arrs, bg, cot = inputs
    cache = {}

    def get(case):
        if case in cache:
            return cache[case]
        kind, which = case
        sized, over = _caps(kind, arrs)
        kw = _kw(kind, sized if which == "sized" else over)
        jfn = jb.composite_tiles_binned if kind == "binned" else \
            jt.composite_tiles_2d

        def jloss(m, c, lo, col, dep, b):
            o = jfn(m, c, lo, col, dep, jnp.asarray(arrs[5]), height=H,
                    width=W, bg=b, interpret=True, **kw)
            return (jnp.sum(o.rgb * cot["rgb"]) + jnp.sum(o.alpha * cot[
                "alpha"]) + jnp.sum(o.depth * cot["depth"])), o

        (_, jout), jgrads = jax.value_and_grad(
            jloss, argnums=tuple(range(6)), has_aux=True)(
            *map(jnp.asarray, arrs[:5]), jnp.asarray(bg))
        packed = packed_of(arrs).requires_grad_(True)
        b = torch.tensor(bg, requires_grad=True)
        tfn = B.composite_tiles_binned if kind == "binned" else \
            T.composite_tiles_2d
        out = tfn(packed, H, W, b, **kw)
        loss = (out.rgb * torch.tensor(cot["rgb"])).sum() + \
            (out.alpha * torch.tensor(cot["alpha"])).sum() + \
            (out.depth * torch.tensor(cot["depth"])).sum()
        gp, gb = torch.autograd.grad(loss, [packed, b])
        lists_fn = B.bin_lists if kind == "binned" else T.tile_lists
        overflow = bool(lists_fn(packed, H, W, *kw.values())[0].overflow)
        cache[case] = (jout, jgrads, out, (gp, gb), overflow)
        return cache[case]

    return get


@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_composite_matches_jax_interpret(results, case):
    jout, _, out, _, overflow = results(case)
    assert overflow == (case[1] == "overflowing")
    for name, atol in (("rgb", 2e-5), ("alpha", 2e-5), ("depth", 2e-4)):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", CASES, ids="-".join)
def test_composite_grad_matches_jax_interpret(results, case, name):
    _, jgrads, _, (gp, gb), _ = results(case)
    ref = np.asarray(jgrads[NAMES.index(name)])
    got = (gb if name == "bg" else gp[:, COLUMNS[name]]).numpy()
    scale = max(np.abs(ref).max(), 1e-3)
    np.testing.assert_allclose(got / scale, ref / scale, rtol=0, atol=5e-5)


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_overflowing_string_drops_pairs(results, kind):
    """The overflowing string renders something else than the sized one:
    pairs were dropped (the same ones in both packages, per the tests
    above)."""
    sized = results((kind, "sized"))[2].rgb.detach()
    over = results((kind, "overflowing"))[2].rgb.detach()
    assert float((sized - over).abs().max()) > 1e-3
