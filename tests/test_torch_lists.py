"""What the list kernels K3-K6 cull by inside a segment's list, held to the
plain list walk on the CPU: the rectangle test a CTA's scan makes before it
reads a splat, the 8x4 block masks of a CTA's span, the counts of what they
save, and the wrapper's host-side pieces (argument checks, the gradient
scratch, the build key). The kernels themselves run only on a card
(tests/test_torch_gpu.py); parity of the list path with the JAX package is
in tests/test_torch_capacity.py and tests/test_torch_capacity_render.py.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from instantsplat_tpu_torch.models.camera import Camera
from instantsplat_tpu_torch.models.gaussians import GaussianModel
from instantsplat_tpu_torch.ops import cuda_build, rasterize
from instantsplat_tpu_torch.ops import rasterize_lists as RL
from instantsplat_tpu_torch.ops import rasterize_pallas as RP
from instantsplat_tpu_torch.ops import rasterize_pallas_binned as RB
from instantsplat_tpu_torch.ops import rasterize_pallas_tiled as RT
from instantsplat_tpu_torch.render.driver import prepare_packed_splats

# the test workers share the machine's cores: two intra-op threads each
torch.set_num_threads(2)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))

import torch_lists_ab  # noqa: E402

OVERFLOWING = {"binned": (1, 2), "tiled": (1, 1, 1)}


def _blob(n, h, w, seed):
    """Packed, depth-sorted splats of a random blob in front of a camera
    (the golden case's construction and shape, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)) * 0.6 + [0.0, 0.0, 4.0]
    g = GaussianModel.create_from_pcd(
        pts, rng.uniform(size=(n, 3)),
        cam_poses=np.array([[1.0, 0, 0, 0, 0, 0, 0]]), max_sh_degree=2,
        device="cpu")
    g.scaling += torch.tensor([0.4, -0.3, 0.1])
    g.opacity += torch.as_tensor(rng.normal(size=(n, 1)) * 2.0,
                                 dtype=torch.float32)
    f = 70.0 * w / 64
    cam = Camera.create(np.eye(3), np.zeros(3), fx=f, fy=f, height=h, width=w,
                        device="cpu")
    with torch.no_grad():
        packed, _ = prepare_packed_splats(g, cam.pose, cam.fx, cam.fy, cam.cx,
                                          cam.cy, 1.0, 2, h, w)
    return packed.contiguous()


def _ragged(n, h, w, seed, spread=9.0):
    """Packed, depth-sorted random splats, a tenth of the rows invalid
    (log-opacity -inf), some centred beyond the image."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform([-5, -5], [w + 5, h + 5], (n, 2))
    s = rng.uniform(0.5, spread, (n, 2))
    rho = rng.uniform(-0.6, 0.6, n)
    a, c, b = s[:, 0] ** 2, s[:, 1] ** 2, rho * s[:, 0] * s[:, 1]
    det = a * c - b * b
    conic = np.stack([c / det, -b / det, a / det], 1)
    lo = np.where(rng.uniform(size=n) > 0.1,
                  np.log(rng.uniform(0.05, 0.99, n)), -np.inf)
    return torch.tensor(np.concatenate(
        [mean2d, conic, lo[:, None], rng.uniform(size=(n, 3)),
         np.sort(rng.uniform(1, 10, n))[:, None]], 1).astype(np.float32))


def _case(kind, case):
    """(packed, h, w, lists, geom, cta_cols): the golden-case shape with
    sized lists, or a ragged shape (width no multiple of 128, invalid rows)
    with sized lists or with a capacity string that overflows."""
    if case == "golden":
        h, w, packed = 48, 64, _blob(400, 48, 64, 42)
    else:
        h, w, packed = 21, 150, _ragged(500, 21, 150, 5)
    cols = (packed[:, :2], packed[:, 2:5], packed[:, 5],
            RL.splat_valid(packed))
    if kind == "binned":
        caps = (OVERFLOWING[kind] if case == "overflow" else
                RB.bin_requirements(*cols, h, w))
        lists, geom = RB.bin_lists(packed, h, w, *caps)
        cta_cols = RB.CTA_COLS
    else:
        caps = (OVERFLOWING[kind] if case == "overflow" else
                RT.tile_requirements(*cols, h, w))
        lists, geom = RT.tile_lists(packed, h, w, *caps)
        cta_cols = RT.CTA_COLS
    assert bool(lists.overflow) == (case == "overflow")
    if case != "golden":
        assert w % 128 and not bool(RL.splat_valid(packed).all())
    return packed, h, w, lists, geom, cta_cols


CASES = [(k, c) for k in ("binned", "tiled")
         for c in ("golden", "ragged", "overflow")]


def _alpha_hits(packed, h, w):
    """[H*W, N] bool: pairs with alpha >= 1/255, the contributors before
    any stop."""
    px, py = rasterize.pixel_coords(h, w, "cpu")
    dx = px[:, None] - packed[None, :, 0]
    dy = py[:, None] - packed[None, :, 1]
    power = (-0.5 * (packed[None, :, 2] * dx * dx + packed[None, :, 4] * dy
                     * dy) - packed[None, :, 3] * dx * dy)
    alpha = torch.clamp(torch.exp(power + packed[None, :, 5]), max=0.99)
    return (power <= 0) & (alpha >= rasterize.ALPHA_EPS)


@pytest.mark.parametrize("kind,case", CASES)
def test_list_culls_keep_every_contributor(kind, case):
    """For every (pixel, list entry) pair with alpha >= 1/255 (every pair
    composite_lists_plain can find a contributor in), the rectangle test
    passes for the pixel's CTA span and the span's block mask marks the
    pixel's 8x4 block."""
    packed, h, w, lists, geom, cta_cols = _case(kind, case)
    seg, j = RL.list_entries(lists, geom)
    assert len(seg) == int(lists.seg_count.sum())
    hits = _alpha_hits(packed, h, w).reshape(h, w, -1)
    sy, sx = seg // geom.n_cols, seg % geom.n_cols
    rect = RP.splat_rects(packed, h, w)
    blocks_x = cta_cols // RP.BLOCK_W
    dy, dx = torch.meshgrid(torch.arange(geom.seg_rows),
                            torch.arange(cta_cols), indexing="ij")
    bit = dy // RP.BLOCK_H * blocks_x + dx // RP.BLOCK_W  # [rows, cols]
    n_pairs = 0
    for c in range(geom.seg_w // cta_cols):
        x0, y0 = sx * geom.seg_w + c * cta_cols, sy * geom.seg_rows
        reached = RL.span_reached(rect[j], x0, y0, cta_cols)
        masks = RP.span_block_masks(packed[j], x0, y0, geom.seg_rows,
                                    cta_cols)
        assert int(masks.max()) < 256  # eight blocks a span, a warp each
        x, y = x0[:, None, None] + dx, y0[:, None, None] + dy  # [E, r, c]
        inside = (x < w) & (y < h)
        hit = inside & hits[y.clamp(max=h - 1), x.clamp(max=w - 1),
                            j[:, None, None]]
        assert bool(reached[hit.any(2).any(1)].all())
        marked = ((masks[:, None, None] >> bit) & 1).bool()
        assert bool(marked[hit].all())
        n_pairs += int(hit.sum())
    assert n_pairs > 1000


def _composite_through_culls(packed, lists, geom, cta_cols, h, w):
    """The walk the list kernels make, in plain torch: per CTA span the
    entries of the segment's list whose rectangle reaches the span, in
    order; per 8x4 block those whose block mask marks it; composited by the
    plain version's scan."""
    rect = RP.splat_rects(packed, h, w)
    acc = torch.zeros((4, h, w))
    tfin = torch.ones((h, w))
    lc = torch.full((h, w), -1, dtype=torch.int64)
    blocks_x = cta_cols // RP.BLOCK_W
    n_blocks = geom.seg_rows // RP.BLOCK_H * blocks_x
    for s in range(geom.n_seg):
        st, k = int(lists.seg_start[s]), int(lists.seg_count[s])
        entries = lists.order[st:st + k].long()
        sy, sx = divmod(s, geom.n_cols)
        for c in range(geom.seg_w // cta_cols):
            x0, y0 = sx * geom.seg_w + c * cta_cols, sy * geom.seg_rows
            if x0 >= w or y0 >= h:
                continue
            ox, oy = torch.full_like(entries, x0), torch.full_like(entries, y0)
            queue = entries[RL.span_reached(rect[entries], ox, oy, cta_cols)]
            masks = RP.span_block_masks(
                packed[queue], ox[:len(queue)], oy[:len(queue)],
                geom.seg_rows, cta_cols)
            for b in range(n_blocks):
                by0 = y0 + b // blocks_x * RP.BLOCK_H
                bx0 = x0 + b % blocks_x * RP.BLOCK_W
                by1, bx1 = min(by0 + RP.BLOCK_H, h), min(bx0 + RP.BLOCK_W, w)
                if by0 >= h or bx0 >= w:
                    continue
                mine = queue[((masks >> b) & 1).bool()]
                py, px = torch.meshgrid(
                    torch.arange(by0, by1, dtype=torch.float32),
                    torch.arange(bx0, bx1, dtype=torch.float32),
                    indexing="ij")
                rgbd, logT, last = rasterize._scan_chunks(
                    packed[mine], mine, px.reshape(-1), py.reshape(-1), 64)
                shape = (by1 - by0, bx1 - bx0)
                acc[:, by0:by1, bx0:bx1] = rgbd.T.reshape(4, *shape)
                tfin[by0:by1, bx0:bx1] = torch.exp(logT).reshape(shape)
                lc[by0:by1, bx0:bx1] = last.reshape(shape)
    return acc, tfin, lc


@pytest.mark.parametrize("kind,case", CASES)
def test_culled_walk_composites_like_plain(kind, case):
    """Culling a segment's list by rectangle and block mask leaves the
    image, the transmittance and the last-contributor index as the plain
    list walk computes them, dropped pairs of an overflowing string
    included."""
    packed, h, w, lists, geom, cta_cols = _case(kind, case)
    acc, tfin, lc = _composite_through_culls(packed, lists, geom, cta_cols,
                                             h, w)
    with torch.no_grad():
        acc_p, tfin_p, lc_p = RL.composite_lists_plain(packed, lists, geom,
                                                       h, w)
    assert int((lc_p >= 0).sum()) > h * w // 4
    np.testing.assert_array_equal(lc.numpy(), lc_p.numpy())
    np.testing.assert_allclose(acc.numpy(), acc_p.numpy(), atol=2e-6)
    np.testing.assert_allclose(tfin.numpy(), tfin_p.numpy(), atol=2e-6)


def _tile_block_masks(rows, tx, ty):
    """The 16x16-tile block masks as they were written before
    span_block_masks took any span."""
    mx, my, ca, cb, cc, lo = (rows[:, c, None, None] for c in range(6))
    m2 = 2.0 * (lo - RP.LOG_ALPHA_EPS)
    dy = (ty[:, None, None] * 16 + torch.arange(16)[None, :, None]) - my
    x0 = (tx[:, None, None] * 16 + torch.arange(0, 16, 8)[None, None, :]) - mx
    dx = torch.minimum(torch.maximum(-cb / ca * dy, x0), x0 + 7)
    t1, t2, t3 = ca * dx * dx, 2.0 * cb * dx * dy, cc * dy * dy
    keep = t1 + t2 + t3 <= m2 + 1e-2 + 1e-5 * (t1 + t2.abs() + t3)
    blocks = keep.view(-1, 4, 4, 2).any(2).reshape(-1, 8)
    return (blocks.int() << torch.arange(8)[None]).sum(1).int()


def test_block_masks_of_a_tile_are_unchanged():
    """block_masks, now span_block_masks of a 16x16 span, returns what it
    returned for K1/K2's tiles."""
    packed = _ragged(1500, 45, 70, 11, spread=4.0)
    rng = np.random.default_rng(12)
    tx = torch.tensor(rng.integers(0, 5, len(packed)))
    ty = torch.tensor(rng.integers(0, 3, len(packed)))
    want = _tile_block_masks(packed, tx, ty)
    got = RP.block_masks(packed, tx, ty)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert 0 < int((want > 0).sum()) < len(packed)


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_list_counts_match_brute_force(kind):
    """list_counts against a count made entry by entry and CTA by CTA on a
    tiny scene whose width leaves one CTA of the last segment beyond the
    image."""
    h, w = 20, 150
    packed = _ragged(60, h, w, 3, spread=6.0)
    if kind == "binned":
        (lists, geom), cta_cols = RB.bin_lists(packed, h, w), RB.CTA_COLS
    else:
        (lists, geom), cta_cols = RT.tile_lists(packed, h, w), RT.CTA_COLS
    rect = RP.splat_rects(packed, h, w).tolist()
    entries = tests = queued = marked = 0
    for s in range(geom.n_seg):
        st, k = int(lists.seg_start[s]), int(lists.seg_count[s])
        sy, sx = divmod(s, geom.n_cols)
        for j in lists.order[st:st + k].tolist():
            entries += 1
            for c in range(geom.seg_w // cta_cols):
                x0, y0 = sx * geom.seg_w + c * cta_cols, sy * geom.seg_rows
                if x0 >= w or y0 >= h:
                    continue
                tests += 1
                x_lo, x_hi, y_lo, y_hi = rect[j]
                if not (x_lo <= (x0 + cta_cols - 1) // 16 and x_hi >= x0 // 16
                        and y_lo <= y0 // 16 <= y_hi):
                    continue
                queued += 1
                mask = int(RP.span_block_masks(
                    packed[j:j + 1], torch.tensor([x0]), torch.tensor([y0]),
                    geom.seg_rows, cta_cols))
                marked += bin(mask).count("1")
    got = RL.list_counts(packed, lists, geom, cta_cols, h, w)
    assert got == RL.ListCounts(entries, tests, queued,
                                entries * geom.seg_rows * geom.seg_w,
                                marked * 32)
    assert 0 < got.queued < got.tests < entries * (geom.seg_w // cta_cols)
    assert 0 < got.pairs_after < got.pairs_before


def test_list_grad_scratch_returns_packed_columns():
    """K4/K6 add into K2's 16-byte-aligned [N, 12] scratch; what the wrapper
    hands to autograd is its first ten columns, usable as d(packed)."""
    assert RL.GRAD_W == RP.GRAD_W == 12 and RL.grad_columns is RP.grad_columns
    rng = np.random.default_rng(3)
    grad = torch.tensor(rng.normal(size=(29, RL.NCOL)).astype(np.float32))
    scratch = torch.zeros((29, RL.GRAD_W))
    assert scratch.data_ptr() % 16 == 0
    assert RL.GRAD_W * scratch.element_size() % 16 == 0
    scratch[:, :RL.NCOL] = grad
    out = RL.grad_columns(scratch)
    assert out.shape == (29, RL.NCOL) and torch.equal(out, grad)
    p = torch.zeros((29, RL.NCOL), requires_grad=True)
    (p * 3.0).backward(out)
    np.testing.assert_array_equal(p.grad.numpy(), 3.0 * grad.numpy())


@pytest.mark.parametrize("kind", ["binned", "tiled"])
def test_list_kernel_wrappers_reject_cpu_tensors(kind):
    """A list kernel is never handed a CPU tensor, and a refused call
    counts no launch; the public entry takes the plain version instead."""
    h, w = 16, 40
    packed = _ragged(30, h, w, 4, spread=4.0)
    if kind == "binned":
        (lists, geom), fwd, bwd = RB.bin_lists(packed, h, w), RB.K3, RB.K4
    else:
        (lists, geom), fwd, bwd = RT.tile_lists(packed, h, w), RT.K5, RT.K6
    rect = RP.scan_plain(packed, h, w).rect
    before = (RP.KR.launches, fwd.launches, bwd.launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RL.lists_forward(fwd, packed, rect, lists, geom, h, w)
    with pytest.raises(ValueError, match="CUDA tensor"):
        RL.lists_backward(bwd, packed, rect, lists, geom,
                          torch.zeros(4, h, w), torch.zeros(h, w),
                          torch.zeros(h, w),
                          torch.zeros(h, w, dtype=torch.int32))
    acc, tfin = RL.composite_lists(packed, lists, geom, h, w, fwd, bwd)
    assert acc.shape == (4, h, w) and tfin.shape == (h, w)
    assert (RP.KR.launches, fwd.launches, bwd.launches) == before


def test_build_key_covers_the_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/compositor.cuh: an edit of the header moves
    both libraries' paths, so no stale library is loaded, and nvcc is given
    csrc/ as an include directory."""
    assert (cuda_build.CSRC / "compositor.cuh") in cuda_build.headers()
    for src in ("rasterize.cu", "rasterize_lists.cu"):
        assert '#include "compositor.cuh"' in (cuda_build.CSRC /
                                               src).read_text()
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    sources = ("rasterize.cu", "rasterize_lists.cu")
    before = [cuda_build.library_path(s) for s in sources]
    assert before == [cuda_build.library_path(s) for s in sources]
    with open(csrc / "compositor.cuh", "a") as f:
        f.write("// edited\n")
    after = [cuda_build.library_path(s) for s in sources]
    assert all(a != b for a, b in zip(after, before))
    # nvcc -I csrc
    calls = []
    monkeypatch.setattr(cuda_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build, "BUILD_ROOT", tmp_path / "build")

    def fake_run(cmd, **kw):
        calls.append(cmd)
        raise RuntimeError("stop before the compiler")

    monkeypatch.setattr(cuda_build.subprocess, "run", fake_run)
    with pytest.raises(RuntimeError, match="stop before"):
        cuda_build.build("rasterize_lists.cu")
    i = calls[0].index("-I")
    assert calls[0][i + 1] == str(csrc)


@pytest.mark.parametrize("name,key", [
    ("void (anonymous namespace)::lists_forward_kernel<4, 64>(float const*, "
     "int2 const*)", "k3"),
    ("void (anonymous namespace)::lists_backward_kernel<4, 64>(float const*)",
     "k4"),
    ("void (anonymous namespace)::lists_forward_kernel<8, 32>(float const*)",
     "k5"),
    ("void (anonymous namespace)::lists_backward_kernel<8, 32>(float const*)",
     "k6"),
    ("(anonymous namespace)::k1_rects_kernel(float const*, int)", "k1_rects"),
    ("void at::native::vectorized_elementwise_kernel<4>", None)])
def test_ab_script_tells_the_list_kernels_apart(name, key):
    """scripts/torch_lists_ab.py sums device time by kernel; K3-K6 are two
    templates, told apart by their arguments as the profiler prints them."""
    assert torch_lists_ab.kernel_key(name) == key
