"""Tracker building blocks: the update transformer and correlation sampling.

Port of ``self_supervise_sfm_tpu/heads/track_modules.py``:

- :func:`mha` has ``nn.MultiheadAttention(batch_first=True)`` semantics
  with fp32 logits (plain products: the tracker's sequences are short);
- the attention blocks add their residuals to the normed input, as the
  reference does;
- :func:`updateformer` interleaves time attention (over the frames of a
  track) with virtual-track space attention (over the tracks of a frame);
- :func:`corr_sample` bilinearly gathers the (2r+1)^2 neighbourhood
  features of every track at every pyramid level and contracts them with
  the track features (no full correlation volume).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..layers import params as P
from .track_utils import bilinear_sample_batched


def init_mha(g, device, dim: int):
    return {"qkv": P.init_linear(g, device, dim, 3 * dim),
            "proj": P.init_linear(g, device, dim, dim)}


def mha(p, x_q: torch.Tensor, x_kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """x_q (B, Nq, C), x_kv (B, Nk, C) -> (B, Nq, C)."""
    B, Nq, C = x_q.shape
    hd = C // num_heads
    w = p["qkv"]["w"].to(x_q.dtype)
    b = p["qkv"].get("b")
    q = x_q @ w[:, :C]
    k = x_kv @ w[:, C:2 * C]
    v = x_kv @ w[:, 2 * C:]
    if b is not None:
        b = b.to(x_q.dtype)
        q, k, v = q + b[:C], k + b[C:2 * C], v + b[2 * C:]

    def split(t):
        return t.reshape(B, -1, num_heads, hd).transpose(1, 2)

    q, k, v = split(q), split(k), split(v)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (hd**0.5)
    probs = torch.softmax(logits, dim=-1).to(x_q.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return P.linear(p["proj"], o.transpose(1, 2).reshape(B, Nq, C))


def init_attn_block(g, device, dim: int, mlp_ratio: float = 4.0, norm_affine: bool = True):
    """``norm_affine=False``: the VGGSfM variant's affine-free norm1 / norm2."""
    hidden = int(dim * mlp_ratio)
    return {
        "norm1": P.init_layer_norm(dim, device, affine=norm_affine),
        "norm2": P.init_layer_norm(dim, device, affine=norm_affine),
        "attn": init_mha(g, device, dim),
        "mlp": {"fc1": P.init_linear(g, device, dim, hidden),
                "fc2": P.init_linear(g, device, hidden, dim)},
    }


def _mlp(p, x, norm_eps):
    h = P.gelu(P.linear(p["mlp"]["fc1"], P.layer_norm(p["norm2"], x, norm_eps)))
    return x + P.linear(p["mlp"]["fc2"], h)


def attn_block(p, x, num_heads: int, norm_eps: float = 1e-5):
    x = P.layer_norm(p["norm1"], x, norm_eps)
    x = x + mha(p["attn"], x, x, num_heads)
    return _mlp(p, x, norm_eps)


def init_cross_attn_block(g, device, dim: int, mlp_ratio: float = 4.0,
                          norm_affine: bool = True):
    p = init_attn_block(g, device, dim, mlp_ratio, norm_affine)
    # norm_context is an affine LayerNorm in both variants
    p["norm_context"] = P.init_layer_norm(dim, device)
    return p


def cross_attn_block(p, x, context, num_heads: int, norm_eps: float = 1e-5):
    x = P.layer_norm(p["norm1"], x, norm_eps)
    ctx = P.layer_norm(p["norm_context"], context)
    x = x + mha(p["attn"], x, ctx, num_heads)
    return _mlp(p, x, norm_eps)


@dataclass(frozen=True)
class UpdateFormerConfig:
    space_depth: int = 6
    time_depth: int = 6
    input_dim: int = 388
    hidden_size: int = 384
    num_heads: int = 8
    output_dim: int = 130
    mlp_ratio: float = 4.0
    add_space_attn: bool = True
    num_virtual_tracks: int = 64
    # input / output LayerNorms (the track-head variant; the VGGSfM variant
    # has neither)
    use_norms: bool = True
    # block norm1 / norm2: affine eps 1e-5, or affine-free eps 1e-6 (VGGSfM)
    block_norm_affine: bool = True
    block_norm_eps: float = 1e-5


def init_updateformer(g, device, cfg: UpdateFormerConfig):
    d = cfg.hidden_size

    def blocks(n, cross=False):
        init = init_cross_attn_block if cross else init_attn_block
        return [init(g, device, d, cfg.mlp_ratio, cfg.block_norm_affine) for _ in range(n)]

    p = {
        "input_transform": P.init_linear(g, device, cfg.input_dim, d),
        "flow_head": P.init_linear(g, device, d, cfg.output_dim),
        "time_blocks": blocks(cfg.time_depth),
    }
    if cfg.use_norms:
        p["input_norm"] = P.init_layer_norm(cfg.input_dim, device)
        p["output_norm"] = P.init_layer_norm(d, device)
    if cfg.add_space_attn:
        p["virtual_tracks"] = P.normal((1, cfg.num_virtual_tracks, 1, d), g, device)
        p["space_virtual_blocks"] = blocks(cfg.space_depth)
        p["space_point2virtual_blocks"] = blocks(cfg.space_depth, cross=True)
        p["space_virtual2point_blocks"] = blocks(cfg.space_depth, cross=True)
    return p


def updateformer(p, x: torch.Tensor, cfg: UpdateFormerConfig) -> torch.Tensor:
    """x (B, N, T, input_dim) -> (B, N, T, output_dim)."""
    if cfg.use_norms:
        x = P.layer_norm(p["input_norm"], x)
    tokens = P.linear(p["input_transform"], x)
    init_tokens = tokens
    B, _, T, C = tokens.shape
    nv = cfg.num_virtual_tracks
    if cfg.add_space_attn:
        virt = p["virtual_tracks"].to(tokens.dtype).expand(B, nv, T, C)
        tokens = torch.cat([tokens, virt], dim=1)
    N = tokens.shape[1]
    stride = (len(p["time_blocks"]) // len(p["space_virtual_blocks"])
              if cfg.add_space_attn else 1)
    j = 0
    for i, tb in enumerate(p["time_blocks"]):
        tt = attn_block(tb, tokens.reshape(B * N, T, C), cfg.num_heads, cfg.block_norm_eps)
        tokens = tt.reshape(B, N, T, C)
        if cfg.add_space_attn and i % stride == 0:
            st = tokens.transpose(1, 2).reshape(B * T, N, C)
            pts, virt = st[:, :N - nv], st[:, N - nv:]
            virt = cross_attn_block(p["space_virtual2point_blocks"][j], virt, pts,
                                    cfg.num_heads, cfg.block_norm_eps)
            virt = attn_block(p["space_virtual_blocks"][j], virt, cfg.num_heads,
                              cfg.block_norm_eps)
            pts = cross_attn_block(p["space_point2virtual_blocks"][j], pts, virt,
                                   cfg.num_heads, cfg.block_norm_eps)
            tokens = torch.cat([pts, virt], dim=1).reshape(B, T, N, C).transpose(1, 2)
            j += 1
    if cfg.add_space_attn:
        tokens = tokens[:, :N - nv]
    tokens = tokens + init_tokens
    if cfg.use_norms:
        tokens = P.layer_norm(p["output_norm"], tokens)
    return P.linear(p["flow_head"], tokens)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., H // 2, W // 2, C), mean of each 2x2 window."""
    H, W, C = x.shape[-3:]
    x = x[..., :H - H % 2, :W - W % 2, :]
    x = x.reshape(*x.shape[:-3], H // 2, 2, W // 2, 2, C)
    return x.sum(dim=(-4, -2)) / 4.0


def build_fmap_pyramid(fmaps: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """(B, S, H, W, C) -> ``num_levels`` maps, each half the previous; pooling
    stops once a side would drop below 2 (the coarsest map repeats)."""
    pyr = [fmaps]
    cur = fmaps
    for _ in range(num_levels - 1):
        if min(cur.shape[-3], cur.shape[-2]) >= 2:
            cur = avg_pool2x2(cur)
        pyr.append(cur)
    return pyr


def corr_sample(pyramid: List[torch.Tensor], targets: torch.Tensor,
                coords: torch.Tensor, radius: int) -> torch.Tensor:
    """Sampled correlation features (B, S, N, levels * (2r+1)^2): zero
    padding, 1/sqrt(C) scaling, the reference's level and offset order.

    targets (B, S, N, C); coords (B, S, N, 2) at level-0 resolution.
    """
    B, S, N, C = targets.shape
    k = 2 * radius + 1
    # the reference adds the axis-0-varying offset to x: keep its order, so
    # that the flattened (2r+1)^2 features line up with converted weights
    d0, d1 = np.meshgrid(np.linspace(-radius, radius, k), np.linspace(-radius, radius, k),
                         indexing="ij")
    delta = torch.from_numpy(np.stack([d0, d1], -1).reshape(-1, 2).astype(np.float32)).to(
        coords.device)
    outs = []
    for lvl, fmaps in enumerate(pyramid):
        pts = (coords / (2.0**lvl))[:, :, :, None, :] + delta  # (B, S, N, k*k, 2)
        feats = bilinear_sample_batched(
            fmaps.reshape(B * S, *fmaps.shape[2:]), pts.reshape(B * S, N, k * k, 2),
            align_corners=True, padding_mode="zeros").reshape(B, S, N, k * k, C)
        corr = torch.einsum("bsnkc,bsnc->bsnk", feats.float(), targets.float()) / (C**0.5)
        outs.append(corr.to(targets.dtype))
    return torch.cat(outs, dim=-1)
