"""DPT-head utilities: sincos position embeddings, UV grids and the
align-corners bilinear resize.

Port of ``self_supervise_sfm_tpu/heads/dpt_utils.py``. The resize is two
interpolation-matrix contractions (the einsum path), except for the large
final upsample, which takes the K3 kernel wrapper (``ops/resize.py``) with
the addend fused.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import resize as RS


@functools.lru_cache(maxsize=None)
def _interp_matrix_ac(n_out: int, n_in: int) -> np.ndarray:
    """1D bilinear interpolation matrix with align_corners=True semantics."""
    A = np.zeros((n_out, n_in), np.float32)
    if n_in == 1 or n_out == 1:
        A[:, 0] = 1.0
        return A
    if n_out == n_in:
        np.fill_diagonal(A, 1.0)
        return A
    scale = (n_in - 1) / (n_out - 1)
    for i in range(n_out):
        src = i * scale
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        A[i, lo] += 1.0 - f
        A[i, hi] += f
    return A


def _resize_einsum(x: torch.Tensor, out_hw) -> torch.Tensor:
    H2, W2 = out_hw
    N, H, W, C = x.shape
    Ah = torch.from_numpy(_interp_matrix_ac(H2, H)).to(x.device, x.dtype)
    Aw = torch.from_numpy(_interp_matrix_ac(W2, W)).to(x.device, x.dtype)
    y = torch.einsum("hi,niwc->nhwc", Ah, x)
    return torch.einsum("wj,nhjc->nhwc", Aw, y)


def resize_bilinear_ac(x: torch.Tensor, out_hw, add=None, out_dtype=None,
                       impl: str = "auto") -> torch.Tensor:
    """(N, H, W, C) -> (N, H2, W2, C), bilinear, align_corners=True.

    ``add``: optional (H2, W2, C) addend applied after the resize; fused
    into the kernel's store on the kernel path.
    ``impl``: "auto" takes the kernel wrapper behind the size gate,
    "kernel" at any size the kernel takes, "einsum" never.
    """
    H2, W2 = out_hw
    N, H, W, C = x.shape
    if (H, W) == (H2, W2):
        y = x if add is None else x + add[None].to(x.dtype)
        return y.to(out_dtype) if out_dtype else y
    if impl != "einsum" and RS.resize_kernel_applicable(
        x.shape, out_hw, 0 if impl == "kernel" else 1 << 27
    ):
        return RS.resize_bilinear(
            x.float().contiguous(), (H2, W2),
            None if add is None else add.float().contiguous(), out_dtype,
        )
    y = _resize_einsum(x, out_hw)
    y = y if add is None else y + add[None].to(y.dtype)
    return y.to(out_dtype) if out_dtype else y


def make_sincos_pos_embed(embed_dim: int, pos: torch.Tensor, omega_0: float = 100.0):
    """1D sincos embedding, (M,) -> (M, embed_dim)."""
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / omega_0 ** (omega / (embed_dim / 2.0))
    out = pos.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).float()


def position_grid_to_embed(pos_grid: torch.Tensor, embed_dim: int, omega_0: float = 100.0):
    """(H, W, 2) -> (H, W, embed_dim)."""
    H, W, _ = pos_grid.shape
    flat = pos_grid.reshape(-1, 2)
    emb_x = make_sincos_pos_embed(embed_dim // 2, flat[:, 0], omega_0)
    emb_y = make_sincos_pos_embed(embed_dim // 2, flat[:, 1], omega_0)
    return torch.cat([emb_x, emb_y], dim=-1).reshape(H, W, embed_dim)


def create_uv_grid(width: int, height: int, aspect_ratio=None, dtype=torch.float32,
                   device=None):
    """(H, W, 2) normalised UV grid."""
    if aspect_ratio is None:
        aspect_ratio = float(width) / float(height)
    diag = (aspect_ratio**2 + 1.0) ** 0.5
    span_x = aspect_ratio / diag
    span_y = 1.0 / diag
    xs = np.linspace(-span_x * (width - 1) / width, span_x * (width - 1) / width,
                     width, dtype=np.float32)
    ys = np.linspace(-span_y * (height - 1) / height, span_y * (height - 1) / height,
                     height, dtype=np.float32)
    uu, vv = np.meshgrid(xs, ys)
    return torch.from_numpy(np.stack([uu, vv], axis=-1)).to(device, dtype)
