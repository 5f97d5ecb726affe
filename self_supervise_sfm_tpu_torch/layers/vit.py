"""DINOv2 vision transformer (the aggregator's patch-embed backbone).

Port of ``self_supervise_sfm_tpu/layers/vit.py``: NHWC images, a Python loop
over per-layer block params in place of ``lax.scan``, and pos-embed
interpolation for non-native grids by half-pixel bilinear interpolation
matrices (none happens at the native grid). Frames are independent through
the ViT, so under an active mesh each block goes through
``parallel/sp_block.py:frame_block_sharded`` (frames cut over data x
context; the plain block without a mesh).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import params as P
from ..parallel.sp_block import block_local, frame_block_sharded
from .block import BlockConfig, init_block, remat_call


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    init_values: float = 1.0
    ln_eps: float = 1e-6
    attn_impl: str = "auto"
    fused_qkv: str = "auto"
    fused_mlp: str = "auto"
    # checkpoint each block (recomputed in the backward)
    remat: bool = False

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def block_cfg(self) -> BlockConfig:
        return BlockConfig(
            dim=self.embed_dim, num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            qk_norm=False, ln_eps=self.ln_eps, init_values=self.init_values,
            attn_impl=self.attn_impl, fused_qkv=self.fused_qkv,
            fused_mlp=self.fused_mlp,
        )


def vit_small(**kw):
    return ViTConfig(embed_dim=384, depth=12, num_heads=6, **kw)


def vit_base(**kw):
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, **kw)


def vit_large(**kw):
    return ViTConfig(embed_dim=1024, depth=24, num_heads=16, **kw)


def vit_giant2(**kw):
    return ViTConfig(embed_dim=1536, depth=40, num_heads=24, **kw)


def init_vit(g, device, cfg: ViTConfig):
    D = cfg.embed_dim
    return {
        "patch_embed": {
            "proj": P.init_conv(g, device, cfg.patch_size, cfg.patch_size, 3, D)
        },
        "cls_token": torch.zeros((1, 1, D), device=device),
        "pos_embed": P.trunc_normal((1, cfg.num_patches + 1, D), g, device, 0.02),
        "register_tokens": (
            P.normal((1, cfg.num_register_tokens, D), g, device, 1e-6)
            if cfg.num_register_tokens else None
        ),
        "blocks": [init_block(g, device, cfg.block_cfg) for _ in range(cfg.depth)],
        "norm": P.init_layer_norm(D, device),
    }


def _interp_matrix(n_out: int, n_in: int) -> np.ndarray:
    """Bilinear (align_corners=False, half-pixel) 1D interpolation matrix."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_out == n_in:
        np.fill_diagonal(A, 1.0)
        return A
    scale = n_in / n_out
    for i in range(n_out):
        src = min(max((i + 0.5) * scale - 0.5, 0.0), n_in - 1)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        A[i, lo] += 1.0 - f
        A[i, hi] += f
    return A


def _interpolate_pos_embed(pos_embed: torch.Tensor, grid_hw, native_grid: int):
    """Resample the (1, 1+N, D) pos embed to a (h, w) patch grid."""
    h, w = grid_hw
    if h == native_grid and w == native_grid:
        return pos_embed
    dev = pos_embed.device
    patch_pe = pos_embed[:, 1:].reshape(1, native_grid, native_grid, -1)
    Ah = torch.from_numpy(_interp_matrix(h, native_grid)).to(dev)
    Aw = torch.from_numpy(_interp_matrix(w, native_grid)).to(dev)
    out = torch.einsum("hi,niwd->nhwd", Ah, patch_pe)
    out = torch.einsum("wj,nhjd->nhwd", Aw, out)
    return torch.cat([pos_embed[:, :1], out.reshape(1, h * w, -1)], dim=1)


def resample_pos_embed(pos_embed: torch.Tensor, target_grid: int) -> torch.Tensor:
    """Resample a stored (1, 1 + g * g, D) pos-embed parameter to a
    ``target_grid`` square grid, once, at load time: a checkpoint trained at
    one ``img_size`` carried into a run at another. Non-native inputs at
    run time go through :func:`_interpolate_pos_embed` inside
    :func:`vit_forward` instead."""
    n = pos_embed.shape[1] - 1
    g = int(round(n ** 0.5))
    if g * g != n:
        raise ValueError(f"pos_embed token count {n} is not a square grid")
    return _interpolate_pos_embed(pos_embed, (target_grid, target_grid), g)


def vit_forward(p, images: torch.Tensor, cfg: ViTConfig, compute_dtype=torch.float32,
                tp_mesh=None):
    """images: (B, H, W, 3), already normalised -> dict of final-norm tokens.
    ``tp_mesh``: the blocks run Megatron's body over its ``model`` group on
    model-local params (the aggregator's tensor-parallel layout); else
    ``frame_block_sharded`` under the active mesh."""
    B, H, W, _ = images.shape
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    x = P.conv2d(p["patch_embed"]["proj"], images.to(compute_dtype),
                 stride=cfg.patch_size, padding="VALID")
    x = x.reshape(B, gh * gw, cfg.embed_dim)
    cls = p["cls_token"].to(compute_dtype).expand(B, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    pe = _interpolate_pos_embed(p["pos_embed"], (gh, gw), cfg.grid)
    x = x + pe.to(compute_dtype)
    r = cfg.num_register_tokens
    if r:
        regs = p["register_tokens"].to(compute_dtype).expand(B, r, cfg.embed_dim)
        x = torch.cat([x[:, :1], regs, x[:, 1:]], dim=1)
    bcfg = cfg.block_cfg
    for bp in p["blocks"]:
        if tp_mesh is None:
            x = remat_call(cfg.remat, frame_block_sharded, bp, x, bcfg)
        else:
            x = remat_call(cfg.remat, block_local, bp, x, bcfg, None, tp_mesh)
    x = P.layer_norm(p["norm"], x, cfg.ln_eps)
    return {
        "x_norm_clstoken": x[:, 0],
        "x_norm_regtokens": x[:, 1: r + 1],
        "x_norm_patchtokens": x[:, r + 1:],
    }
