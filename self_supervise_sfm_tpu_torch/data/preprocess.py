"""Host-side image preprocessing and correspondence sampling.

Port of ``self_supervise_sfm_tpu/data/preprocess.py`` (numpy; PIL for the
Pillow-semantics resize, imported where it is used). Every output is a
fixed-shape numpy array (NHWC, float32):

- pad to square (centred) with zeros, bicubic resize to ``target_size``,
  with the 3x3 ``K -> K'`` / ``K' -> K`` intrinsic-recovery matrices;
- depth PNGs are uint16 millimetres -> float32 metres;
- correspondences are drawn certainty-weighted with replacement to a fixed
  ``sample_num``, with a bilinear depth lookup of ``grid_sample``'s
  ``align_corners=False`` coordinate rule.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _pad_resize_params(w: int, h: int, target_size: int):
    max_side = max(w, h)
    pad_left = (max_side - w) // 2
    pad_top = (max_side - h) // 2
    scale = target_size / max_side
    return max_side, pad_left, pad_top, scale


def intrinsic_recovery_matrices(
    w: int, h: int, target_size: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(K_to_K_prime, K_prime_to_K) for the pad+resize transform."""
    _, pad_left, pad_top, scale = _pad_resize_params(w, h, target_size)
    ox, oy = pad_left * scale, pad_top * scale
    K_to_K_prime = np.array(
        [[scale, 0, ox], [0, scale, oy], [0, 0, 1]], np.float32
    )
    K_prime_to_K = np.array(
        [[1 / scale, 0, -ox / scale], [0, 1 / scale, -oy / scale], [0, 0, 1]],
        np.float32,
    )
    return K_to_K_prime, K_prime_to_K


def preprocess_image(
    image, target_size: int = 518, is_depth: bool = False
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL image -> (processed array, K_to_K_prime, K_prime_to_K).

    RGB: (target, target, 3) float32 in [0, 1].  Depth: (target, target)
    float32 metres.
    """
    from PIL import Image

    if not is_depth:
        image = image.convert("RGB")
    w, h = image.size
    max_side, pad_left, pad_top, _ = _pad_resize_params(w, h, target_size)
    if (w, h) != (max_side, max_side):
        padded = Image.new(image.mode, (max_side, max_side), color=0)
        padded.paste(image, (pad_left, pad_top))
        image = padded
    image = image.resize((target_size, target_size), Image.Resampling.BICUBIC)
    arr = np.array(image)
    if is_depth:
        arr = arr.astype(np.float32) / 1000.0  # mm -> m
    else:
        arr = arr.astype(np.float32) / 255.0
    K2Kp, Kp2K = intrinsic_recovery_matrices(w, h, target_size)
    return arr, K2Kp, Kp2K


def ncoords_to_pixels(coords: np.ndarray, h: int, w: int) -> np.ndarray:
    """[-1, 1] normalised -> pixel coords: x -> (x + 1)(w - 1) / 2."""
    out = coords.copy()
    out[..., 0] = (coords[..., 0] + 1) * (w - 1) / 2
    out[..., 1] = (coords[..., 1] + 1) * (h - 1) / 2
    return out


def _grid_sample_bilinear(img: np.ndarray, ncoords: np.ndarray) -> np.ndarray:
    """``F.grid_sample(mode="bilinear", align_corners=False,
    padding_mode="zeros")`` on a single-channel image.

    img: (H, W); ncoords: (N, 2) in [-1, 1] (x, y). Returns (N,).
    """
    H, W = img.shape
    x = (ncoords[:, 0] + 1) * W / 2 - 0.5
    y = (ncoords[:, 1] + 1) * H / 2 - 0.5
    x0 = np.floor(x).astype(np.int64)
    y0 = np.floor(y).astype(np.int64)

    out = np.zeros(ncoords.shape[0], np.float32)
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xi = x0 + dx
        yi = y0 + dy
        wgt = (1 - np.abs(x - xi)) * (1 - np.abs(y - yi))
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        vals = np.where(inside, img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)], 0.0)
        out += (wgt * vals).astype(np.float32)
    return out


def sample_correspondence_and_depth(
    coords_src: np.ndarray,
    coords_dst: np.ndarray,
    certainty: np.ndarray,
    depth_src: np.ndarray,
    depth_dst: np.ndarray,
    sample_num: int,
    min_corres_conf: float = 0.0,
    rng: np.random.Generator | None = None,
):
    """Certainty-weighted sampling of dense correspondences and depths.

    All inputs flattened over the dense grid; returns pixel-space coords
    (sample_num, 2) x2 and depths (sample_num,) x2.
    """
    rng = rng or np.random.default_rng()
    coords_src = coords_src.reshape(-1, 2)
    coords_dst = coords_dst.reshape(-1, 2)
    certainty = certainty.reshape(-1)

    sel = certainty > min_corres_conf
    if not sel.any():
        raise ValueError(
            f"No correspondences above min_corres_conf={min_corres_conf}"
        )
    cs, cd, cert = coords_src[sel], coords_dst[sel], certainty[sel]
    probs = cert / cert.sum()
    idx = rng.choice(len(cert), size=sample_num, replace=True, p=probs)
    cs, cd = cs[idx], cd[idx]

    d_src = _grid_sample_bilinear(depth_src.astype(np.float32), cs)
    d_dst = _grid_sample_bilinear(depth_dst.astype(np.float32), cd)

    h1, w1 = depth_src.shape
    h2, w2 = depth_dst.shape
    return (
        ncoords_to_pixels(cs, h1, w1).astype(np.float32),
        ncoords_to_pixels(cd, h2, w2).astype(np.float32),
        d_src,
        d_dst,
    )
