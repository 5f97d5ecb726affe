"""In-training geometric self-audit.

Port of ``self_supervise_sfm_tpu/utils/sanity_check.py`` on the port's
``ops/geometry.py``: pick a correspondence pair, recover the predicted
intrinsics to original image space, reproject the pair's correspondences
with the predicted relative pose and the measured depth, and report the
pixel offset from the measured matches. Runs on the host (CPU tensors), at
the trainer's ``sanity_check_every`` interval.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import geometry as G


def sanity_check_relative_poses(
    extrinsic: np.ndarray,  # (S, 3, 4) predicted (processed space)
    intrinsic: np.ndarray,  # (S, 3, 3) predicted (processed space)
    scene: Dict[str, Any],  # un-batched numpy scene dict
    pair: Optional[int] = None,
    save_path: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, float]:
    """Returns {mean_px_offset, median_px_offset, pair} for one pair."""
    rng = rng or np.random.default_rng()
    valid = np.flatnonzero(scene["pair_valid"] > 0)
    if len(valid) == 0:
        return {"mean_px_offset": float("nan"), "median_px_offset": float("nan"), "pair": -1}
    p = int(pair if pair is not None else rng.choice(valid))

    t = torch.from_numpy
    extrinsic = np.asarray(extrinsic, np.float32)
    si, di = int(scene["src_idx"][p]), int(scene["dst_idx"][p])
    recovered_K = scene["K_prime_to_K"] @ np.asarray(intrinsic)
    rel = G.relative_pose(t(extrinsic[si: si + 1]), t(extrinsic[di: di + 1]))
    ones = torch.ones((1, 1), dtype=torch.float32)
    pred_dst, _ = G.backproject_and_reproject(
        t(scene["src_coords"][p: p + 1]), t(scene["src_depth"][p: p + 1]),
        t(recovered_K[si: si + 1]), t(recovered_K[di: di + 1]), rel, ones)
    offsets = G.compute_projective_residual(
        pred_dst, t(scene["dst_coords"][p: p + 1]))[0].numpy()

    if save_path is not None and "images" in scene:
        from .vls import correspondence_overlay

        correspondence_overlay(
            scene["images"][si], scene["images"][di], scene["src_coords"][p],
            scene["dst_coords"][p], pred_dst[0].numpy(), save_path=save_path)

    return {
        "mean_px_offset": float(offsets.mean()),
        "median_px_offset": float(np.median(offsets)),
        "pair": p,
    }
