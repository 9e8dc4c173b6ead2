"""The port's MASt3R (models/mast3r.py, models/mast3r_infer.py,
convert.mast3r_from_numpy) against the JAX package's on the CPU, on
tests/test_mast3r.py's TINY configuration, float32:

- `random:SEED` weights: the port's numpy draw equals JAX's
  `init_params` leaf for leaf, and `convert.mast3r_from_numpy` maps it to
  a state dict that JAX's `convert_torch_checkpoint` maps back to the
  same tree;
- the same synthetic upstream-keyed state dict through JAX's converter
  and the port's loader: encoder tokens, every decoder hook and every head
  output within 1e-5 of the largest magnitude (landscape and portrait);
- `infer_pairs` (with a padded last batch) and `infer_pairs_mixed` +
  `mixed_results_to_prediction` against JAX's;
- bf16 against float32 under tests/test_mast3r.py's law;
- two pins of what the JAX package computes where it differs from
  upstream MASt3R: the DPT's transposed convs see their kernel flipped,
  and its stride-2 conv pads as XLA "SAME" (0, 1 on an even grid, 1, 1 on
  an odd one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from instantsplat_tpu.models import mast3r as jm
from instantsplat_tpu.models import mast3r_infer as jinfer
from instantsplat_tpu_torch import convert
from instantsplat_tpu_torch.models import mast3r as tm
from instantsplat_tpu_torch.models import mast3r_infer as tinfer
from torch_init_cases import TINY, fake_upstream_sd

torch.set_num_threads(2)

JTINY = jm.MASt3RConfig(**dataclasses.asdict(TINY))
TOL = 1e-5  # of the largest magnitude of the JAX output (float32)
# the JAX model jitted whole: eager JAX compiles every op on its own
_encode = jax.jit(lambda p, x: jm.encode_images(p, JTINY, x))
_decode = jax.jit(lambda p, f1, q1, f2, q2: jm.decode_pair(p, JTINY, f1, q1,
                                                           f2, q2))
_head = jax.jit(lambda p, d, h, w: jm.catmlp_dpt_head(p, JTINY, d, h, w),
                static_argnums=(2, 3))


def assert_close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: {err:.3e} > {tol:g}"


@pytest.fixture(scope="module")
def upstream():
    """(JAX params, port model) of the same synthetic state dict."""
    sd = fake_upstream_sd(TINY)
    model = tm.load_upstream_state_dict(tm.MASt3R(TINY).eval(), sd)
    return jm.convert_torch_checkpoint(sd, JTINY), model


def test_fake_state_dict_is_the_jax_tests_copy():
    from test_mast3r import TINY as J_TINY, _fake_torch_sd

    assert J_TINY == JTINY
    want = _fake_torch_sd(J_TINY)
    got = fake_upstream_sd(TINY)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_random_weights_are_jax_init_params():
    tree = tm.init_params_numpy(TINY, seed=3)
    want = jm.init_params(JTINY, seed=3)
    flat_t, flat_w = _leaves(tree), _leaves(want)
    assert flat_t.keys() == flat_w.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_t[k], np.asarray(flat_w[k]),
                                      err_msg=k)
    sd = convert.mast3r_from_numpy(tree)
    model = tm.build_model("random:3", TINY, device="cpu")
    assert model.state_dict().keys() == sd.keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    # JAX's converter reads the port's state dict back into the same tree
    back = jm.convert_torch_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, JTINY)
    for k, v in _leaves(back).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(flat_w[k]),
                                      err_msg=k)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("hw", [(32, 48), (48, 32)],
                         ids=["landscape", "portrait"])
def test_layers_match_jax(upstream, hw):
    params, model = upstream
    h, w = hw
    rng = np.random.default_rng(4)
    imgs = rng.random((2, h, w, 3)).astype(np.float32)
    jf, jpos = _encode(params, imgs)
    jd1, jd2 = _decode(params, jf[:1], jpos[:1], jf[1:], jpos[1:])
    with torch.no_grad():
        tf, grid = model.encode(torch.from_numpy(imgs))
        td1, td2 = model.decode(tf[:1], grid, tf[1:], grid)
        th1 = model.downstream_head1(td1, h, w)
        th2 = model.downstream_head2(td2, h, w)
    assert_close(tf, jf, what="encoder tokens")
    assert len(td1) == len(jd1) == TINY.dec_depth + 1
    for k in range(len(jd1)):
        assert_close(td1[k], jd1[k], what=f"decoder 1 hook {k}")
        assert_close(td2[k], jd2[k], what=f"decoder 2 hook {k}")
    jh1 = _head(params["head1"], jd1, h, w)
    jh2 = _head(params["head2"], jd2, h, w)
    for k in ("pts3d", "conf", "desc", "desc_conf"):
        assert_close(th1[k], jh1[k], what=f"head 1 {k}")
        assert_close(th2[k], jh2[k], what=f"head 2 {k}")


def test_random_model_forward_matches_jax():
    """`random:1` through the port's forward against JAX's forward_pair
    semantics (encode both, decode, heads) with init_params(seed=1)."""
    params = jm.init_params(JTINY, seed=1)
    model = tm.build_model("random:1", TINY, device="cpu")
    rng = np.random.default_rng(0)
    ab = rng.random((2, 32, 48, 3)).astype(np.float32)
    jf, jpos = _encode(params, ab)
    jd1, jd2 = _decode(params, jf[:1], jpos[:1], jf[1:], jpos[1:])
    j1 = _head(params["head1"], jd1, 32, 48)
    j2 = _head(params["head2"], jd2, 32, 48)
    with torch.no_grad():
        t1, t2 = model(torch.from_numpy(ab[:1]), torch.from_numpy(ab[1:]))
    for k in j1:
        assert_close(t1[k], j1[k], what=f"res1 {k}")
        assert_close(t2[k], j2[k], what=f"res2 {k}")


def test_infer_pairs_matches_jax(upstream):
    params, model = upstream
    rng = np.random.default_rng(5)
    imgs = rng.random((3, 32, 32, 3)).astype(np.float32)
    pairs = [(0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1)]
    # batch 4 over 6 pairs: the last batch is padded with pair 0
    want = jinfer.infer_pairs(params, JTINY, imgs, pairs, batch_size=4)
    got = tinfer.infer_pairs(model, imgs, pairs, batch_size=4)
    assert got.edges == want.edges
    for k in ("pred_i", "pred_j", "conf_i", "conf_j", "desc_i", "desc_j"):
        assert getattr(got, k).dtype == np.float32
        assert_close(getattr(got, k), getattr(want, k), what=k)
    with pytest.raises(TypeError, match="infer_pairs_mixed"):
        tinfer.infer_pairs(model, [imgs[0], imgs[0, :16]], [(0, 1)])


def test_infer_pairs_mixed_matches_jax(upstream):
    from instantsplat_tpu_torch.init.pairs import make_pair_indices

    params, model = upstream
    rng = np.random.default_rng(11)
    shapes = [(32, 48), (48, 32)]
    imgs = [rng.random((h, w, 3)).astype(np.float32) for h, w in shapes]
    pairs = make_pair_indices(2, "complete", symmetrize=True)
    want = jinfer.infer_pairs_mixed(params, JTINY, imgs, pairs)
    got = tinfer.infer_pairs_mixed(model, imgs, pairs)
    assert len(got) == len(want)
    for e, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for k in w:
            assert_close(g[k], w[k], what=f"pair {pairs[e]} {k}")
    jp = jinfer.mixed_results_to_prediction(want, pairs, shapes)
    tp = tinfer.mixed_results_to_prediction(got, pairs, shapes)
    np.testing.assert_array_equal(tp.shapes, jp.shapes)
    for k in ("pred_i", "pred_j", "conf_i", "conf_j"):
        assert_close(getattr(tp, k), getattr(jp, k), what=k)
    assert (tp.conf_i[pairs.index((0, 1)), 32:] == 1.0).all()  # padding


def test_bf16_inference_close_to_f32():
    model = tm.build_model("random:0", TINY, device="cpu")
    rng = np.random.default_rng(11)
    imgs = rng.random((2, 32, 32, 3)).astype(np.float32)
    pairs = [(0, 1), (1, 0)]
    p32 = tinfer.infer_pairs(model, imgs, pairs, batch_size=2)
    model16 = tm.build_model("random:0", TINY, device="cpu",
                             dtype=torch.bfloat16)
    assert model16.enc_norm.weight.dtype == torch.float32
    assert model16.enc_blocks[0].attn.qkv.bias.dtype == torch.bfloat16
    p16 = tinfer.infer_pairs(model16, imgs, pairs, batch_size=2)
    scale = np.abs(p32.pred_i).max()
    d = np.abs(p16.pred_i - p32.pred_i) / scale
    assert np.quantile(d, 0.999) < 0.05, np.quantile(d, 0.999)
    assert d.max() < 0.5, d.max()
    assert p16.pred_i.dtype == np.float32


def test_transposed_conv_sees_a_flipped_kernel(upstream):
    """act_postprocess.0.1 / .1.1: the JAX package's lax.conv_transpose
    (transpose_kernel=False) is torch's conv_transpose2d with the kernel
    flipped, not stock conv_transpose2d."""
    params, model = upstream
    rng = np.random.default_rng(2)
    for i, stride in ((0, 4), (1, 2)):
        conv = model.downstream_head1.dpt.act_postprocess[i][1]
        x = rng.standard_normal((1, 3, 2, conv.in_channels)).astype(
            np.float32)
        want = np.asarray(jm._conv_transpose(
            params["head1"]["dpt"]["act"][i]["resample"], jnp.asarray(x),
            stride)).transpose(0, 3, 1, 2)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        with torch.no_grad():
            got = tm.conv_transpose_flipped(xt, conv)
            flipped = F.conv_transpose2d(xt, conv.weight.flip(-1, -2),
                                         conv.bias, stride=stride)
            stock = conv(xt)
        assert_close(got, want, what=f"branch {i}")
        torch.testing.assert_close(got, flipped, rtol=0, atol=0)
        assert (stock - got).abs().max() > 1e-3


@pytest.mark.parametrize("n,pads", [(4, (0, 1)), (5, (1, 1))],
                         ids=["even", "odd"])
def test_stride2_conv_pads_as_xla_same(upstream, n, pads):
    params, model = upstream
    conv = model.downstream_head1.dpt.act_postprocess[3][1]
    assert tm.same_pads(n, 3, 2) == pads
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, n, n, conv.in_channels)).astype(np.float32)
    want = np.asarray(jm._conv(params["head1"]["dpt"]["act"][3]["resample"],
                               jnp.asarray(x), stride=2)).transpose(0, 3, 1, 2)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = tm.conv_same_stride(xt, conv)
        padded = F.conv2d(F.pad(xt, (pads[0], pads[1], pads[0], pads[1])),
                          conv.weight, conv.bias, stride=2)
        upstream_pad = F.conv2d(xt, conv.weight, conv.bias, stride=2,
                                padding=1)
    assert_close(got, want, what="stride-2 conv")
    torch.testing.assert_close(got, padded, rtol=0, atol=0)
    differs = bool((upstream_pad - got).abs().max() > 1e-3)
    assert differs == (pads != (1, 1))


def test_checkpoint_file_and_missing_keys(upstream, tmp_path):
    _, model = upstream
    sd = fake_upstream_sd(TINY)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()},
                "args": "AsymmetricMASt3R(...)"}, path)
    loaded = tm.load_checkpoint(path, tm.MASt3R(TINY).eval())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=0, atol=0)
    # dec_blocks2 reuses dec_blocks (the duplication rule)
    torch.testing.assert_close(loaded.dec_blocks2[3].attn.qkv.weight,
                               loaded.dec_blocks[3].attn.qkv.weight)
    del sd["enc_norm.weight"]
    with pytest.raises(KeyError, match="enc_norm.weight"):
        tm.load_upstream_state_dict(tm.MASt3R(TINY), sd)
