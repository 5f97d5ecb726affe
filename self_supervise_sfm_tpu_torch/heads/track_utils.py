"""Tracker utilities: bilinear sampling and the sincos embeddings.

Port of ``self_supervise_sfm_tpu/heads/track_utils.py``, NHWC. The sampler
is a four-tap gather with the JAX package's weights, order of the sum and
border / zero padding, over a batch of feature maps at once (the JAX
package ``vmap``s its one-map sampler).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch


def bilinear_sample_batched(imgs: torch.Tensor, coords: torch.Tensor,
                            align_corners: bool = True,
                            padding_mode: str = "border") -> torch.Tensor:
    """imgs (B, H, W, C), coords (B, ..., 2) as (x, y) pixels -> (B, ..., C).

    ``align_corners=True``: x in [0, W - 1] addresses pixel centres.
    ``padding_mode``: "border" clamps the taps, "zeros" zeroes the taps
    outside the map.
    """
    B, H, W, C = imgs.shape
    x, y = coords[..., 0], coords[..., 1]
    if not align_corners:
        x, y = x - 0.5, y - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = imgs.reshape(B * H * W, C)
    base = (torch.arange(B, device=imgs.device) * (H * W)).reshape(
        (B,) + (1,) * (coords.dim() - 2))

    def gather(xi, yi):
        xc = torch.clamp(xi, 0, W - 1).long()
        yc = torch.clamp(yi, 0, H - 1).long()
        vals = flat[base + yc * W + xc]
        if padding_mode == "zeros":
            inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            vals = torch.where(inside[..., None], vals, torch.zeros((), dtype=vals.dtype,
                                                                    device=vals.device))
        return vals

    v00 = gather(x0, y0)
    v10 = gather(x0 + 1, y0)
    v01 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    w00 = ((1 - fx) * (1 - fy))[..., None]
    w10 = (fx * (1 - fy))[..., None]
    w01 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return v00 * w00 + v10 * w10 + v01 * w01 + v11 * w11


def bilinear_sample_nhwc(img: torch.Tensor, coords: torch.Tensor,
                         align_corners: bool = True,
                         padding_mode: str = "border") -> torch.Tensor:
    """img (H, W, C) sampled at coords (..., 2) -> (..., C)."""
    return bilinear_sample_batched(img[None], coords[None], align_corners,
                                   padding_mode)[0]


def sample_features(fmap: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """(H, W, C) sampled at (N, 2) xy -> (N, C), align_corners=True, border."""
    return bilinear_sample_nhwc(fmap, coords)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: Union[int, Tuple[int, int]],
                            device=None) -> torch.Tensor:
    """(H, W, embed_dim) fp32, 10000-base, made in float64 with numpy."""
    gh, gw = grid_size if isinstance(grid_size, tuple) else (grid_size, grid_size)
    omega = np.arange(embed_dim // 4, dtype=np.float64) / (embed_dim / 4.0)
    omega = 1.0 / 10000**omega

    def embed_1d(pos):
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    xs, ys = np.meshgrid(np.arange(gw, dtype=np.float64), np.arange(gh, dtype=np.float64))
    # the reference's order: emb_h from the x grid, emb_w from the y grid
    emb = np.concatenate([embed_1d(xs), embed_1d(ys)], axis=1).reshape(gh, gw, embed_dim)
    return torch.from_numpy(emb.astype(np.float32)).to(device)


def get_2d_embedding(xy: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    """(..., N, 2) -> (..., N, 2C [+2]): the tracker's multiplicative
    frequency embedding, sin on the even channels and cos on the odd."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    div_term = (torch.arange(0, C, 2, dtype=torch.float32, device=xy.device)
                * (1000.0 / C)).reshape((1,) * (xy.dim() - 1) + (C // 2,))

    def interleave(sin, cos):
        return torch.stack([sin, cos], dim=-1).reshape(*sin.shape[:-1], C)

    pe_x = interleave(torch.sin(x * div_term), torch.cos(x * div_term))
    pe_y = interleave(torch.sin(y * div_term), torch.cos(y * div_term))
    pe = torch.cat([pe_x, pe_y], dim=-1)
    return torch.cat([xy, pe], dim=-1) if cat_coords else pe
