"""Carry weights and optimiser state between the JAX and PyTorch packages
as numpy arrays.

`gaussians_from_numpy` / `adam_state_from_numpy` take the fields of the JAX
`GaussianModel` / `AdamState` (passed as numpy arrays, e.g.
`{f: np.asarray(getattr(g, f)) for f in PARAM_FIELDS}`) and build the
port's tensors; `to_numpy` goes back. `lpips_from_numpy` builds the port's
LPIPS network from the JAX `LpipsVGG` arrays, `mast3r_from_numpy` the
MASt3R state dict from the JAX parameter tree. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from instantsplat_tpu_torch.eval.image_metrics import LpipsVGG
from instantsplat_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
from instantsplat_tpu_torch.opt.gaussian_opt import AdamState


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


def gaussians_from_numpy(arrays: dict, max_sh_degree: int,
                         device="cuda") -> GaussianModel:
    """arrays: field name -> array for every field in PARAM_FIELDS."""
    return GaussianModel(**{f: _t(arrays[f], device) for f in PARAM_FIELDS},
                         max_sh_degree=int(max_sh_degree))


def adam_state_from_numpy(m: dict, v: dict, step: int,
                          per_point_lr: Optional[np.ndarray] = None,
                          device="cuda") -> AdamState:
    """m, v: field name -> moment array; step: Adam steps taken."""
    return AdamState(
        m={f: _t(m[f], device) for f in PARAM_FIELDS},
        v={f: _t(v[f], device) for f in PARAM_FIELDS},
        step=int(step),
        per_point_lr=(None if per_point_lr is None
                      else _t(per_point_lr, device)),
    )


def lpips_from_numpy(conv_w, conv_b, lin_w, device="cuda") -> LpipsVGG:
    """The JAX LpipsVGG's conv_w (HWIO), conv_b and lin_w (HWIO) arrays ->
    the port's network (OIHW)."""
    def oihw(ws):
        return [np.asarray(w).transpose(3, 2, 0, 1) for w in ws]

    return LpipsVGG.from_arrays(oihw(conv_w), conv_b, oihw(lin_w),
                                device=device)


def to_numpy(obj) -> dict:
    """GaussianModel -> {field: array, "max_sh_degree": int};
    AdamState -> {"m": {...}, "v": {...}, "step": int, "per_point_lr": ...}."""
    def a(t):
        return t.detach().cpu().numpy()

    if isinstance(obj, GaussianModel):
        out = {f: a(getattr(obj, f)) for f in PARAM_FIELDS}
        out["max_sh_degree"] = obj.max_sh_degree
        return out
    if isinstance(obj, AdamState):
        return {"m": {f: a(obj.m[f]) for f in PARAM_FIELDS},
                "v": {f: a(obj.v[f]) for f in PARAM_FIELDS},
                "step": obj.step,
                "per_point_lr": (None if obj.per_point_lr is None
                                 else a(obj.per_point_lr))}
    raise TypeError(f"cannot convert {type(obj).__name__}")


def mast3r_from_numpy(tree) -> dict:
    """The JAX MASt3R parameter tree (nested dicts and lists of arrays:
    linears [din, dout], convs HWIO, LayerNorm scale/bias) -> the state
    dict of the port's `models.mast3r.MASt3R`, under upstream's key names.
    The DPT resample kernels of branches 0 and 1 are transposed convs:
    HWIO (cin, cout) -> torch's [cin, cout, kh, kw]."""
    sd = {}

    def put(name, a, perm=None):
        # a read-only array (a JAX array's view) is copied first; the
        # layout change runs in torch (blocked and threaded: several
        # times numpy's speed on ViT-L's matrices)
        t = torch.from_numpy(np.require(a, np.float32, ["W"]))
        sd[name] = t.permute(perm).contiguous() if perm else t

    def lin(name, p):
        put(f"{name}.weight", p["w"], (1, 0))
        put(f"{name}.bias", p["b"])

    def ln(name, p):
        put(f"{name}.weight", p["scale"])
        put(f"{name}.bias", p["bias"])

    def conv(name, p, transpose=False):
        put(f"{name}.weight", p["w"],
            (2, 3, 0, 1) if transpose else (3, 2, 0, 1))
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def block(pre, p):
        ln(f"{pre}.norm1", p["norm1"])
        lin(f"{pre}.attn.qkv", p["attn"]["qkv"])
        lin(f"{pre}.attn.proj", p["attn"]["proj"])
        ln(f"{pre}.norm2", p["norm2"])
        lin(f"{pre}.mlp.fc1", p["mlp"]["fc1"])
        lin(f"{pre}.mlp.fc2", p["mlp"]["fc2"])
        if "cross_attn" in p:
            ln(f"{pre}.norm3", p["norm3"])
            ln(f"{pre}.norm_y", p["norm_y"])
            for k in ("projq", "projk", "projv", "proj"):
                lin(f"{pre}.cross_attn.{k}", p["cross_attn"][k])

    conv("patch_embed.proj", tree["patch_embed"])
    for i, p in enumerate(tree["enc_blocks"]):
        block(f"enc_blocks.{i}", p)
    ln("enc_norm", tree["enc_norm"])
    lin("decoder_embed", tree["decoder_embed"])
    for name in ("dec_blocks", "dec_blocks2"):
        for i, p in enumerate(tree[name]):
            block(f"{name}.{i}", p)
    ln("dec_norm", tree["dec_norm"])
    for n in (1, 2):
        pre = f"downstream_head{n}"
        dpt = tree[f"head{n}"]["dpt"]
        for i, branch in enumerate(dpt["act"]):
            conv(f"{pre}.dpt.act_postprocess.{i}.0", branch["project"])
            if "resample" in branch:
                conv(f"{pre}.dpt.act_postprocess.{i}.1", branch["resample"],
                     transpose=i in (0, 1))
        for i, p in enumerate(dpt["layer_rn"]):
            conv(f"{pre}.dpt.scratch.layer{i + 1}_rn", p)
        for i, p in enumerate(dpt["refine"]):
            rp = f"{pre}.dpt.scratch.refinenet{i + 1}"
            for unit, key in (("resConfUnit1", "res1"),
                              ("resConfUnit2", "res2")):
                conv(f"{rp}.{unit}.conv1", p[key]["conv1"])
                conv(f"{rp}.{unit}.conv2", p[key]["conv2"])
            conv(f"{rp}.out_conv", p["out_conv"])
        conv(f"{pre}.dpt.head.0", dpt["head"]["conv1"])
        conv(f"{pre}.dpt.head.2", dpt["head"]["conv2"])
        lf = tree[f"head{n}"]["local_features"]
        lin(f"{pre}.head_local_features.fc1", lf["fc1"])
        lin(f"{pre}.head_local_features.fc2", lf["fc2"])
    return sd


def mast3r_to_numpy(state_dict) -> dict:
    """Inverse of `mast3r_from_numpy`: a MASt3R state dict (upstream key
    names, torch layouts; tensors or arrays) -> the JAX parameter tree of
    numpy float32 arrays (linears [din, dout], convs HWIO, the
    transposed-conv kernels of DPT branches 0 and 1 from [cin, cout, kh,
    kw], LayerNorm scale/bias). The layout maps only move elements, so
    they serve Adam's moments as well as the parameters."""
    def get(name, perm=None):
        a = state_dict[name]
        t = (a.detach() if torch.is_tensor(a)
             else torch.from_numpy(np.require(a, np.float32, ["W"])))
        t = t.float()
        # the layout change runs in torch, on the tensor's device; a copy
        # either way (a CPU tensor's numpy() would share its memory)
        t = t.permute(perm).contiguous() if perm else t.clone()
        return t.cpu().numpy()

    def lin(name):
        return {"w": get(f"{name}.weight", (1, 0)), "b": get(f"{name}.bias")}

    def ln(name):
        return {"scale": get(f"{name}.weight"), "bias": get(f"{name}.bias")}

    def conv(name, transpose=False):
        p = {"w": get(f"{name}.weight",
                      (2, 3, 0, 1) if transpose else (2, 3, 1, 0))}
        if f"{name}.bias" in state_dict:
            p["b"] = get(f"{name}.bias")
        return p

    def count(prefix):
        return len({k.split(".")[1] for k in state_dict
                    if k.startswith(prefix + ".")})

    def block(pre, cross):
        p = {"norm1": ln(f"{pre}.norm1"),
             "attn": {"qkv": lin(f"{pre}.attn.qkv"),
                      "proj": lin(f"{pre}.attn.proj")},
             "norm2": ln(f"{pre}.norm2"),
             "mlp": {"fc1": lin(f"{pre}.mlp.fc1"),
                     "fc2": lin(f"{pre}.mlp.fc2")}}
        if cross:
            p["norm3"] = ln(f"{pre}.norm3")
            p["norm_y"] = ln(f"{pre}.norm_y")
            p["cross_attn"] = {k: lin(f"{pre}.cross_attn.{k}")
                               for k in ("projq", "projk", "projv", "proj")}
        return p

    def head(n):
        pre = f"downstream_head{n}.dpt"
        act = []
        for i in range(4):
            branch = {"project": conv(f"{pre}.act_postprocess.{i}.0")}
            if f"{pre}.act_postprocess.{i}.1.weight" in state_dict:
                branch["resample"] = conv(f"{pre}.act_postprocess.{i}.1",
                                          transpose=i in (0, 1))
            act.append(branch)
        refine = []
        for i in range(4):
            rp = f"{pre}.scratch.refinenet{i + 1}"
            refine.append({
                key: {"conv1": conv(f"{rp}.{unit}.conv1"),
                      "conv2": conv(f"{rp}.{unit}.conv2")}
                for unit, key in (("resConfUnit1", "res1"),
                                  ("resConfUnit2", "res2"))})
            refine[-1]["out_conv"] = conv(f"{rp}.out_conv")
        lf = f"downstream_head{n}.head_local_features"
        return {"dpt": {
            "act": act,
            "layer_rn": [conv(f"{pre}.scratch.layer{i + 1}_rn")
                         for i in range(4)],
            "refine": refine,
            "head": {"conv1": conv(f"{pre}.head.0"),
                     "conv2": conv(f"{pre}.head.2")}},
            "local_features": {"fc1": lin(f"{lf}.fc1"),
                               "fc2": lin(f"{lf}.fc2")}}

    return {
        "patch_embed": conv("patch_embed.proj"),
        "enc_blocks": [block(f"enc_blocks.{i}", False)
                       for i in range(count("enc_blocks"))],
        "enc_norm": ln("enc_norm"),
        "decoder_embed": lin("decoder_embed"),
        "dec_blocks": [block(f"dec_blocks.{i}", True)
                       for i in range(count("dec_blocks"))],
        "dec_blocks2": [block(f"dec_blocks2.{i}", True)
                        for i in range(count("dec_blocks2"))],
        "dec_norm": ln("dec_norm"),
        "head1": head(1),
        "head2": head(2),
    }
