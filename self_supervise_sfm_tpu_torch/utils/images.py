"""Image loading and pixel-grid helpers (host side, numpy).

Port of ``self_supervise_sfm_tpu/utils/images.py``: square pad + resize
loading with the placement of each original image in the processed frame,
pixel-coordinate grids and mask budgeting. PIL is imported where an image
is read.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..data.preprocess import _pad_resize_params, preprocess_image


def load_and_preprocess_images_square(
    image_path_list: List[str], target_size: int = 518
) -> Tuple[np.ndarray, np.ndarray]:
    """Load images, centre-pad to square, resize.

    Returns (images (N, T, T, 3) float32 [0,1],
             original_coords (N, 6) = [x1, y1, x2, y2, width, height] giving
             each original image's placement in the processed frame).
    """
    from PIL import Image

    if not image_path_list:
        raise ValueError("At least 1 image is required")
    images, coords = [], []
    for path in image_path_list:
        img = Image.open(path)
        if img.mode == "RGBA":
            bg = Image.new("RGBA", img.size, (255, 255, 255, 255))
            img = Image.alpha_composite(bg, img)
        img = img.convert("RGB")
        w, h = img.size
        # same transform parameters as preprocess_image, from one source
        _, left, top, scale = _pad_resize_params(w, h, target_size)
        x1, y1 = left * scale, top * scale
        x2, y2 = (left + w) * scale, (top + h) * scale
        arr, _, _ = preprocess_image(img, target_size, is_depth=False)
        images.append(arr)
        coords.append([x1, y1, x2, y2, w, h])
    return np.stack(images), np.asarray(coords, np.float32)


def randomly_limit_trues(
    mask: np.ndarray, max_trues: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """Randomly keep at most ``max_trues`` True entries (``helper.py:10-33``)."""
    rng = rng or np.random.default_rng()
    idx = np.flatnonzero(mask)
    if idx.size <= max_trues:
        return mask
    keep = rng.choice(idx, size=max_trues, replace=False)
    out = np.zeros(mask.size, bool)
    out[keep] = True
    return out.reshape(mask.shape)


def create_pixel_coordinate_grid(
    num_frames: int, height: int, width: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(num_frames, H, W, 3) of (x, y, frame) + same-shape validity mask."""
    y, x = np.mgrid[0:height, 0:width]
    out = np.zeros((num_frames, height, width, 3), np.float32)
    out[..., 0] = x
    out[..., 1] = y
    out[..., 2] = np.arange(num_frames, dtype=np.float32)[:, None, None]
    return out, np.ones((num_frames, height, width), bool)
