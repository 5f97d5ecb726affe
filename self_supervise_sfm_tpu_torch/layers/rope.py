"""2D rotary position embeddings: precomputed tables, applied per head.

Port of ``self_supervise_sfm_tpu/layers/rope.py``: the first half of the head
features is rotated by the y position, the second half by x; within each
half a 1D rope with duplicated angles and the ``(-t2, t1)`` rotation.
Special tokens sit at position (0, 0), the identity rotation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def position_grid(height: int, width: int, device=None) -> torch.Tensor:
    """(H*W, 2) fp32 grid of (y, x) patch positions."""
    yy, xx = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    grid = np.stack([yy.ravel(), xx.ravel()], axis=-1).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def rope_tables(pos: torch.Tensor, head_dim: int, base_frequency: float = 100.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape ``pos.shape[:-1] + (head_dim,)`` for (..., N, 2) pos."""
    half = head_dim // 2
    exponents = torch.arange(0, half, 2, dtype=torch.float32, device=pos.device) / half
    inv_freq = 1.0 / (base_frequency**exponents)

    def one_axis(p):
        ang = p[..., None].float() * inv_freq
        ang = torch.cat([ang, ang], dim=-1)
        return torch.cos(ang), torch.sin(ang)

    cos_y, sin_y = one_axis(pos[..., 0])
    cos_x, sin_x = one_axis(pos[..., 1])
    return torch.cat([cos_y, cos_x], dim=-1), torch.cat([sin_y, sin_x], dim=-1)


def _rotate_half_block(t: torch.Tensor) -> torch.Tensor:
    d = t.shape[-1]
    return torch.cat([-t[..., d // 2:], t[..., : d // 2]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, H, N, hd); cos/sin: (B, N, hd) or (N, hd), broadcast over heads."""
    if cos.dim() == x.dim() - 1:
        cos = cos[..., None, :, :]
        sin = sin[..., None, :, :]
    cos = cos.to(x.dtype)
    sin = sin.to(x.dtype)
    half = x.shape[-1] // 2
    xv, xh = x[..., :half], x[..., half:]
    out_v = xv * cos[..., :half] + _rotate_half_block(xv) * sin[..., :half]
    out_h = xh * cos[..., half:] + _rotate_half_block(xh) * sin[..., half:]
    return torch.cat([out_v, out_h], dim=-1)
