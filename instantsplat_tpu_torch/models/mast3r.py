"""MASt3R / DUSt3R pointmap transformer as one `nn.Module` (port of
instantsplat_tpu/models/mast3r.py).

Architecture (the MASt3R ViT-Large checkpoint configuration,
`AsymmetricMASt3R`, mast3r/model.py:40-68 -> dust3r/model.py:55-210):

- siamese encoder: patch-16 conv embed -> 24 pre-norm transformer blocks,
  dim 1024 / 16 heads, 2D RoPE (freq 100) on q and k: the first half of
  each head's channels rotates by the patch's y index, the second by x,
  each with rotate-half RoPE;
- two decoders run in lockstep (dec_blocks for view 1, dec_blocks2 for
  view 2): 12 blocks, dim 768 / 12 heads; each block is self-attention
  (RoPE), cross-attention to the OTHER view's previous-layer tokens
  (RoPE on q with the query view's positions, on k with the memory's;
  the memory re-normed by norm_y) and an MLP;
- heads ('catmlp+dpt', 'pts3d+desc24'): a DPT pyramid over the hooks
  [enc_out, dec6, dec9, dec12] giving 3+1 channels at full resolution,
  plus an MLP over cat(enc_out, dec12) pixel-shuffled to 24-dim local
  descriptors with their own confidence;
- postprocess: pts3d = dir * expm1(|xyz|), conf = 1 + exp(x), desc
  L2-normalized.

Parameter names are upstream's (`enc_blocks.{i}.attn.qkv`,
`downstream_head{n}.dpt.act_postprocess.{i}.{0,1}`, ...), so a MASt3R
`.pth` loads with `load_upstream_state_dict` (which applies the
dec_blocks2 duplication rule). It computes what the JAX package computes,
including two points where the JAX package differs from upstream MASt3R:
the transposed convs of `act_postprocess.0.1` / `.1.1` see their kernel
flipped (JAX's `lax.conv_transpose` without `transpose_kernel`), and the
stride-2 conv of `act_postprocess.3.1` pads as XLA's "SAME" does (0, 1 on
an even grid, where upstream pads 1, 1). Tokens are [B, S, D] in
row-major patch order; images come in as [B, H, W, 3] in [0, 1].

Mixed precision (`cast(torch.bfloat16)`, as JAX's `cast_params`):
matrices, convs and linear biases in bf16; LayerNorm weights stay f32 and
its statistics are taken in f32; attention's softmax accumulates in f32;
the head postprocess runs in f32.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_freq: float = 100.0
    local_feat_dim: int = 24
    two_confs: bool = True
    dpt_feature_dim: int = 256
    dpt_last_dim: int = 128
    dpt_layer_dims: tuple = (96, 192, 384, 768)
    ln_eps: float = 1e-6

    @property
    def dpt_hooks(self):
        l2 = self.dec_depth
        return (0, l2 * 2 // 4, l2 * 3 // 4, l2)

    @property
    def dpt_dim_tokens(self):
        return (self.enc_embed_dim, self.dec_embed_dim,
                self.dec_embed_dim, self.dec_embed_dim)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


class LayerNorm(nn.LayerNorm):
    """Statistics in f32 whatever the token dtype; output in the token
    dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, din, dhidden, dout):
        super().__init__()
        self.fc1 = nn.Linear(din, dhidden)
        self.fc2 = nn.Linear(dhidden, dout)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def rope_tables(hp: int, wp: int, head_dim: int, freq: float, dtype,
                device):
    """(cos_y, sin_y, cos_x, sin_x), each [S, head_dim // 2], for the
    row-major (y, x) positions of an hp x wp patch grid. Angles in f32,
    cast to the token dtype."""
    half = head_dim // 2
    inv = 1.0 / (freq ** (torch.arange(0, half // 2, dtype=torch.float32,
                                       device=device) * 2 / half))
    gy, gx = torch.meshgrid(torch.arange(hp, device=device),
                            torch.arange(wp, device=device), indexing="ij")
    out = []
    for p in (gy.reshape(-1), gx.reshape(-1)):
        ang = p[:, None].to(torch.float32) * inv
        ang = torch.cat([ang, ang], -1)
        out += [torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)]
    return tuple(out)


def _rotate_half(x):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], -1)


def apply_rope2d(tokens, rope):
    """tokens [B, heads, S, hd]; rope = rope_tables(...) of its grid."""
    cos_y, sin_y, cos_x, sin_x = rope
    y_tok, x_tok = tokens.chunk(2, dim=-1)
    y_tok = y_tok * cos_y + _rotate_half(y_tok) * sin_y
    x_tok = x_tok * cos_x + _rotate_half(x_tok) * sin_x
    return torch.cat([y_tok, x_tok], -1)


def _heads(x, n_heads):
    b, s, d = x.shape
    return x.reshape(b, s, n_heads, d // n_heads).transpose(1, 2)


def _merge(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


class Attention(nn.Module):
    def __init__(self, dim, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, rope):
        q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = apply_rope2d(_heads(q, self.n_heads), rope)
        k = apply_rope2d(_heads(k, self.n_heads), rope)
        out = F.scaled_dot_product_attention(q, k, _heads(v, self.n_heads))
        return self.proj(_merge(out))


class CrossAttention(nn.Module):
    def __init__(self, dim, n_heads):
        super().__init__()
        self.n_heads = n_heads
        self.projq = nn.Linear(dim, dim)
        self.projk = nn.Linear(dim, dim)
        self.projv = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, y, xrope, yrope):
        q = apply_rope2d(_heads(self.projq(x), self.n_heads), xrope)
        k = apply_rope2d(_heads(self.projk(y), self.n_heads), yrope)
        v = _heads(self.projv(y), self.n_heads)
        return self.proj(_merge(F.scaled_dot_product_attention(q, k, v)))


class Block(nn.Module):
    """Encoder block: pre-norm self-attention and MLP."""

    def __init__(self, dim, n_heads, mlp_ratio, eps):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, n_heads)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_ratio * dim, dim)

    def forward(self, x, rope):
        x = x + self.attn(self.norm1(x), rope)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """croco DecoderBlock: self-attention, cross-attention to the normed
    memory, MLP."""

    def __init__(self, dim, n_heads, mlp_ratio, eps):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, n_heads)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.cross_attn = CrossAttention(dim, n_heads)
        self.norm3 = LayerNorm(dim, eps=eps)
        self.norm_y = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, mlp_ratio * dim, dim)

    def forward(self, x, y, xrope, yrope):
        x = x + self.attn(self.norm1(x), xrope)
        x = x + self.cross_attn(self.norm2(x), self.norm_y(y), xrope, yrope)
        return x + self.mlp(self.norm3(x))


# ---------------------------------------------------------------------------
# DPT head
# ---------------------------------------------------------------------------


def conv_transpose_flipped(x, conv: nn.ConvTranspose2d):
    """What JAX's `lax.conv_transpose` (transpose_kernel=False) computes on
    the same weights: torch's transposed conv with the kernel flipped."""
    return F.conv_transpose2d(x, conv.weight.flip(-1, -2), conv.bias,
                              stride=conv.stride)


def same_pads(n: int, k: int, s: int):
    """XLA "SAME" padding (low, high) of one spatial dim."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_same_stride(x, conv: nn.Conv2d):
    """A strided conv padded as XLA's "SAME" pads it."""
    (k, _), (s, _) = conv.kernel_size, conv.stride
    top, bottom = same_pads(x.shape[-2], k, s)
    left, right = same_pads(x.shape[-1], k, s)
    return F.conv2d(F.pad(x, (left, right, top, bottom)), conv.weight,
                    conv.bias, stride=s)


def resize2x(x):
    """Bilinear x2 with align_corners=True."""
    return F.interpolate(x, size=(x.shape[-2] * 2, x.shape[-1] * 2),
                         mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.conv1 = nn.Conv2d(dim, dim, 3, padding=1)
        self.conv2 = nn.Conv2d(dim, dim, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FusionBlock(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(dim)
        self.resConfUnit2 = ResidualConvUnit(dim)
        self.out_conv = nn.Conv2d(dim, dim, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(resize2x(self.resConfUnit2(x)))


class _Scratch(nn.Module):
    def __init__(self, layer_dims, fd):
        super().__init__()
        for i, d in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(d, fd, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i + 1}", FusionBlock(fd))


class DPTHead(nn.Module):
    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        ld, fd = cfg.dpt_layer_dims, cfg.dpt_feature_dim
        act = []
        for i, (dt, d) in enumerate(zip(cfg.dpt_dim_tokens, ld)):
            branch = [nn.Conv2d(dt, d, 1)]
            if i == 0:
                branch.append(nn.ConvTranspose2d(d, d, 4, stride=4))
            elif i == 1:
                branch.append(nn.ConvTranspose2d(d, d, 2, stride=2))
            elif i == 3:
                branch.append(nn.Conv2d(d, d, 3, stride=2))
            act.append(nn.ModuleList(branch))
        self.act_postprocess = nn.ModuleList(act)
        self.scratch = _Scratch(ld, fd)
        self.head = nn.ModuleDict({
            "0": nn.Conv2d(fd, cfg.dpt_last_dim, 3, padding=1),
            "2": nn.Conv2d(cfg.dpt_last_dim, 4, 1)})

    def forward(self, hook_tokens, h, w):
        """4 token tensors [B, S, C] -> [B, 4, H, W]."""
        hp, wp = h // self.patch_size, w // self.patch_size
        feats = []
        for i, tok in enumerate(hook_tokens):
            f = tok.transpose(1, 2).reshape(tok.shape[0], -1, hp, wp)
            branch = self.act_postprocess[i]
            f = branch[0](f)
            if i in (0, 1):
                f = conv_transpose_flipped(f, branch[1])
            elif i == 3:
                f = conv_same_stride(f, branch[1])
            feats.append(getattr(self.scratch, f"layer{i + 1}_rn")(f))
        s = self.scratch
        path = s.refinenet4(feats[3])
        path = path[:, :, :feats[2].shape[2], :feats[2].shape[3]]
        path = s.refinenet3(path, feats[2])
        path = s.refinenet2(path, feats[1])
        path = s.refinenet1(path, feats[0])
        # the 1x1 output conv BEFORE the x2 upsample: both are linear, so
        # they commute exactly (the JAX package's order)
        return resize2x(self.head["2"](self.head["0"](path)))


class CatMLPHead(nn.Module):
    """Cat_MLP_LocalFeatures_DPT_Pts3d forward + postprocess."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        n_out = (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size**2
        self.dpt = DPTHead(cfg)
        self.head_local_features = Mlp(idim, 4 * idim, n_out)

    def forward(self, dec_list, h, w):
        """-> dict(pts3d [B,H,W,3], conf [B,H,W], desc [B,H,W,24],
        desc_conf [B,H,W]), all f32."""
        cfg = self.cfg
        raw = self.dpt([dec_list[i] for i in cfg.dpt_hooks], h, w).float()
        lf = self.head_local_features(
            torch.cat([dec_list[0], dec_list[-1]], -1))
        hp, wp = h // cfg.patch_size, w // cfg.patch_size
        lf = F.pixel_shuffle(lf.transpose(1, 2).reshape(
            lf.shape[0], -1, hp, wp), cfg.patch_size).float()
        xyz = raw[:, :3].permute(0, 2, 3, 1)
        d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
        desc = lf[:, :cfg.local_feat_dim].permute(0, 2, 3, 1)
        conf = 1.0 + torch.exp(raw[:, 3])
        return dict(
            pts3d=xyz / torch.clamp(d, min=1e-8) * torch.expm1(d),
            conf=conf,
            desc=desc / torch.clamp(
                torch.linalg.norm(desc, dim=-1, keepdim=True), min=1e-12),
            desc_conf=(1.0 + torch.exp(lf[:, cfg.local_feat_dim])
                       if cfg.two_confs else conf))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class MASt3R(nn.Module):
    def __init__(self, cfg: MASt3RConfig = MASt3RConfig()):
        super().__init__()
        self.cfg = cfg
        de, dd, eps = cfg.enc_embed_dim, cfg.dec_embed_dim, cfg.ln_eps
        self.patch_embed = PatchEmbed(cfg.patch_size, de)
        self.enc_blocks = nn.ModuleList(
            Block(de, cfg.enc_num_heads, cfg.mlp_ratio, eps)
            for _ in range(cfg.enc_depth))
        self.enc_norm = LayerNorm(de, eps=eps)
        self.decoder_embed = nn.Linear(de, dd)
        self.dec_blocks = nn.ModuleList(
            DecoderBlock(dd, cfg.dec_num_heads, cfg.mlp_ratio, eps)
            for _ in range(cfg.dec_depth))
        self.dec_blocks2 = nn.ModuleList(
            DecoderBlock(dd, cfg.dec_num_heads, cfg.mlp_ratio, eps)
            for _ in range(cfg.dec_depth))
        self.dec_norm = LayerNorm(dd, eps=eps)
        self.downstream_head1 = CatMLPHead(cfg)
        self.downstream_head2 = CatMLPHead(cfg)

    @property
    def dtype(self):
        return self.decoder_embed.weight.dtype

    def cast(self, dtype):
        """Mixed precision as JAX's `cast_params`: everything but the
        LayerNorm weights to `dtype`. Returns self."""
        for m in self.modules():
            if not isinstance(m, LayerNorm):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dtype)
        return self

    def _rope(self, grid, n_heads, dim):
        return rope_tables(grid[0], grid[1], dim // n_heads,
                           self.cfg.rope_freq, self.dtype,
                           self.decoder_embed.weight.device)

    def encode(self, images):
        """images [B, H, W, 3] in [0, 1] -> (tokens [B, S, D], (hp, wp)).
        The images are cast to the model's dtype before x*2-1."""
        cfg = self.cfg
        b, h, w, _ = images.shape
        if h % cfg.patch_size or w % cfg.patch_size:
            raise ValueError(f"image {h}x{w} is not a multiple of the "
                             f"patch size {cfg.patch_size}")
        x = images.to(self.dtype) * 2.0 - 1.0  # DUSt3R ImgNorm
        x = self.patch_embed.proj(x.permute(0, 3, 1, 2))
        grid = (h // cfg.patch_size, w // cfg.patch_size)
        tokens = x.flatten(2).transpose(1, 2)
        rope = self._rope(grid, cfg.enc_num_heads, cfg.enc_embed_dim)
        for blk in self.enc_blocks:
            tokens = blk(tokens, rope)
        return self.enc_norm(tokens), grid

    def decode(self, f1, grid1, f2, grid2):
        """Both decoders in lockstep, each block reading the other view's
        previous tokens. -> (dec1, dec2): [enc_out, block1..blockN], the
        last entry dec_norm-ed."""
        cfg = self.cfg
        r1 = self._rope(grid1, cfg.dec_num_heads, cfg.dec_embed_dim)
        r2 = self._rope(grid2, cfg.dec_num_heads, cfg.dec_embed_dim)
        out1, out2 = [f1], [f2]
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, r1, r2), blk2(x2, x1, r2, r1)
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        return out1, out2

    def forward_from_encoded(self, f1, f2, hw1, hw2=None):
        """Decoder + heads on cached encoder tokens; hw1 / hw2 are the
        views' image shapes (hw2 defaults to hw1). res2's pts3d are in
        view 1's frame."""
        hw2 = hw1 if hw2 is None else hw2
        p = self.cfg.patch_size
        dec1, dec2 = self.decode(f1, (hw1[0] // p, hw1[1] // p),
                                 f2, (hw2[0] // p, hw2[1] // p))
        return (self.downstream_head1(dec1, *hw1),
                self.downstream_head2(dec2, *hw2))

    def forward(self, img1, img2):
        """(res1, res2) for image batches [B, H, W, 3] in [0, 1]."""
        b, h, w, _ = img1.shape
        f, _ = self.encode(torch.cat([img1, img2], 0))
        return self.forward_from_encoded(f[:b], f[b:], (h, w))


# ---------------------------------------------------------------------------
# weights: upstream state dicts and the JAX package's random init
# ---------------------------------------------------------------------------


def load_upstream_state_dict(model: MASt3R, state_dict):
    """Load a MASt3R state dict (AsymmetricMASt3R naming) into `model`,
    applying the dec_blocks2 duplication rule (dust3r/model.py:90-97): if
    absent, dec_blocks weights are reused. Keys the model does not use are
    ignored; a key it needs and the dict lacks raises."""
    sd = dict(state_dict)
    if not any(k.startswith("dec_blocks2") for k in sd):
        for k in list(sd):
            if k.startswith("dec_blocks."):
                sd[k.replace("dec_blocks.", "dec_blocks2.", 1)] = sd[k]
    sd = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
          for k, v in sd.items()}
    missing, _ = model.load_state_dict(sd, strict=False)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} of the model's "
                       f"keys, e.g. {missing[:5]}")
    return model


def load_checkpoint(path, model: MASt3R):
    """Load a MASt3R .pth checkpoint ({'model': state_dict} or a bare
    state dict) into `model`."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    return load_upstream_state_dict(model, sd)


def init_params_numpy(cfg: MASt3RConfig = MASt3RConfig(), seed: int = 0):
    """The JAX package's `init_params(cfg, seed)` tree as numpy arrays:
    the same `default_rng(seed)` draws in the same order (linears [din,
    dout] scaled by 1/sqrt(din), convs HWIO scaled by 1/sqrt(kh kw cin),
    biases zero, LayerNorms ones and zeros). `convert.mast3r_from_numpy`
    maps it to the module's state dict."""
    rng = np.random.default_rng(seed)

    def ln(d):
        return {"scale": np.ones(d, np.float32),
                "bias": np.zeros(d, np.float32)}

    def linear(din, dout):
        return {"w": rng.standard_normal((din, dout)).astype(np.float32)
                * (1.0 / math.sqrt(din)),
                "b": np.zeros(dout, np.float32)}

    def conv(kh, kw, cin, cout, bias=True):
        p = {"w": rng.standard_normal((kh, kw, cin, cout)).astype(np.float32)
             * (1.0 / math.sqrt(kh * kw * cin))}
        if bias:
            p["b"] = np.zeros(cout, np.float32)
        return p

    def enc_blk(d):
        return {"norm1": ln(d),
                "attn": {"qkv": linear(d, 3 * d), "proj": linear(d, d)},
                "norm2": ln(d),
                "mlp": {"fc1": linear(d, cfg.mlp_ratio * d),
                        "fc2": linear(cfg.mlp_ratio * d, d)}}

    def dec_blk(d):
        return {**enc_blk(d), "norm3": ln(d), "norm_y": ln(d),
                "cross_attn": {"projq": linear(d, d), "projk": linear(d, d),
                               "projv": linear(d, d), "proj": linear(d, d)}}

    def dpt():
        ld, fd = cfg.dpt_layer_dims, cfg.dpt_feature_dim
        act = []
        for i, (dt, d) in enumerate(zip(cfg.dpt_dim_tokens, ld)):
            branch = {"project": conv(1, 1, dt, d)}
            if i in (0, 1, 3):
                k = {0: 4, 1: 2, 3: 3}[i]
                branch["resample"] = conv(k, k, d, d)
            act.append(branch)
        return {
            "act": act,
            "layer_rn": [conv(3, 3, d, fd, bias=False) for d in ld],
            "refine": [{"res1": {"conv1": conv(3, 3, fd, fd),
                                 "conv2": conv(3, 3, fd, fd)},
                        "res2": {"conv1": conv(3, 3, fd, fd),
                                 "conv2": conv(3, 3, fd, fd)},
                        "out_conv": conv(1, 1, fd, fd)} for _ in range(4)],
            "head": {"conv1": conv(3, 3, fd, cfg.dpt_last_dim),
                     "conv2": conv(1, 1, cfg.dpt_last_dim, 4)},
        }

    def head():
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        n_out = (cfg.local_feat_dim + int(cfg.two_confs)) * cfg.patch_size**2
        return {"dpt": dpt(),
                "local_features": {"fc1": linear(idim, 4 * idim),
                                   "fc2": linear(4 * idim, n_out)}}

    d_e, d_d = cfg.enc_embed_dim, cfg.dec_embed_dim
    tree = {"patch_embed": conv(cfg.patch_size, cfg.patch_size, 3, d_e)}
    tree["enc_blocks"] = [enc_blk(d_e) for _ in range(cfg.enc_depth)]
    tree["enc_norm"] = ln(d_e)
    tree["decoder_embed"] = linear(d_e, d_d)
    tree["dec_blocks"] = [dec_blk(d_d) for _ in range(cfg.dec_depth)]
    tree["dec_blocks2"] = [dec_blk(d_d) for _ in range(cfg.dec_depth)]
    tree["dec_norm"] = ln(d_d)
    tree["head1"] = head()
    tree["head2"] = head()
    return tree


def build_model(ckpt_path: str, cfg: MASt3RConfig = MASt3RConfig(),
                device="cuda", dtype=None) -> MASt3R:
    """The model of `ckpt_path`: "random" / "random:SEED" (the JAX
    package's `init_params(cfg, SEED)` weights) or an upstream .pth; in
    eval mode on `device`, cast to `dtype` when given."""
    from instantsplat_tpu_torch import convert, resolve_device

    dev = resolve_device(device)
    with torch.device("meta"):
        model = MASt3R(cfg)
    model = model.to_empty(device=dev).eval().requires_grad_(False)
    if ckpt_path == "random" or ckpt_path.startswith("random:"):
        seed = int(ckpt_path.split(":", 1)[1]) if ":" in ckpt_path else 0
        model.load_state_dict(convert.mast3r_from_numpy(
            init_params_numpy(cfg, seed)))
    else:
        load_checkpoint(ckpt_path, model)
    return model.cast(dtype) if dtype is not None else model


def build_trainable(ckpt_path: str, cfg: MASt3RConfig = MASt3RConfig(),
                    device="cuda") -> MASt3R:
    """The training counterpart of `build_model`: float32 master
    parameters that require grad, on `device`, from "random:SEED" (the
    JAX package's `init_params(cfg, SEED)`) or an upstream .pth. Mixed
    precision is the trainer's business (bf16 copies of these masters per
    step), not the module's."""
    model = build_model(ckpt_path, cfg, device=device)
    return model.float().requires_grad_(True)
