"""Camera/pose geometry for inference, in fp32.

Port of the inference subset of ``self_supervise_sfm_tpu/ops/geometry.py``:
pose decoding and depth unprojection. Extrinsics are OpenCV world-to-camera
``[R|t]`` (..., 3, 4); quaternions are scalar-last xyzw; the pose encoding
is ``[tx ty tz, qx qy qz qw, fov_h fov_w]``. The JAX package pins these
matmuls to full fp32 on the TPU; on the card the model entry turns TF32
off for the same reason.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def pad_poses(pose34: torch.Tensor) -> torch.Tensor:
    """Pad (..., 3, 4) to (..., 4, 4) with the row [0, 0, 0, 1]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose34.dtype,
                          device=pose34.device)
    bottom = bottom.expand(*pose34.shape[:-2], 1, 4)
    return torch.cat([pose34[..., :3, :4], bottom], dim=-2)


def se3_inverse(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse of (..., 3|4, 4) world-to-cam -> (..., 4, 4)."""
    R = pose[..., :3, :3]
    t = pose[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    return pad_poses(torch.cat([Rt, -Rt @ t], dim=-1))


def quat_to_mat(quaternions: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyzw quaternion -> (..., 3, 3) rotation matrix."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*quaternions.shape[:-1], 3, 3)


def pose_encoding_to_extri_intri(pose_encoding: torch.Tensor,
                                 image_size_hw: Tuple[int, int]):
    """(..., 9) -> ((..., 3, 4) extrinsics, (..., 3, 3) intrinsics); the
    principal point is the image centre."""
    T = pose_encoding[..., :3]
    R = quat_to_mat(pose_encoding[..., 3:7])
    extrinsics = torch.cat([R, T[..., None]], dim=-1)
    H, W = image_size_hw
    # tan clamped away from 0: a relu'd FoV head emits exactly 0 at init
    fy = (H / 2.0) / torch.clamp(torch.tan(pose_encoding[..., 7] / 2.0), min=1e-6)
    fx = (W / 2.0) / torch.clamp(torch.tan(pose_encoding[..., 8] / 2.0), min=1e-6)
    zeros = torch.zeros_like(fx)
    row0 = torch.stack([fx, zeros, torch.full_like(fx, W / 2.0)], dim=-1)
    row1 = torch.stack([zeros, fy, torch.full_like(fy, H / 2.0)], dim=-1)
    row2 = torch.stack([zeros, zeros, torch.ones_like(fx)], dim=-1)
    return extrinsics, torch.stack([row0, row1, row2], dim=-2)


def pose_encoding_to_extri_intri_np64(pose_encoding, image_size_hw=None,
                                      build_intrinsics: bool = True):
    """Host-side float64 pose decode (numpy): the math of
    :func:`pose_encoding_to_extri_intri` at double precision over the
    (..., 9) fp32 encoding. Returns numpy arrays."""
    enc = np.asarray(pose_encoding, np.float64)
    T = enc[..., :3]
    q = enc[..., 3:7]
    i, j, k, r = np.moveaxis(q, -1, 0)
    two_s = 2.0 / np.sum(q * q, axis=-1)
    R = np.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        axis=-1,
    ).reshape(q.shape[:-1] + (3, 3))
    extrinsics = np.concatenate([R, T[..., None]], axis=-1)
    intrinsics = None
    if build_intrinsics:
        if image_size_hw is None:
            raise ValueError("intrinsics need the image size")
        H, W = image_size_hw
        fy = (H / 2.0) / np.maximum(np.tan(enc[..., 7] / 2.0), 1e-6)
        fx = (W / 2.0) / np.maximum(np.tan(enc[..., 8] / 2.0), 1e-6)
        zeros = np.zeros_like(fx)
        ones = np.ones_like(fx)
        row0 = np.stack([fx, zeros, np.full_like(fx, W / 2.0)], axis=-1)
        row1 = np.stack([zeros, fy, np.full_like(fy, H / 2.0)], axis=-1)
        row2 = np.stack([zeros, zeros, ones], axis=-1)
        intrinsics = np.stack([row0, row1, row2], axis=-2)
    return extrinsics, intrinsics


def depth_to_cam_points(depth_map: torch.Tensor, intrinsic: torch.Tensor) -> torch.Tensor:
    """(..., H, W) depth + (..., 3, 3) K -> (..., H, W, 3) camera-frame points."""
    H, W = depth_map.shape[-2:]
    u = torch.arange(W, dtype=depth_map.dtype, device=depth_map.device)[None, :]
    v = torch.arange(H, dtype=depth_map.dtype, device=depth_map.device)[:, None]
    fu = intrinsic[..., 0, 0][..., None, None]
    fv = intrinsic[..., 1, 1][..., None, None]
    cu = intrinsic[..., 0, 2][..., None, None]
    cv = intrinsic[..., 1, 2][..., None, None]
    x = (u - cu) * depth_map / fu
    y = (v - cv) * depth_map / fv
    return torch.stack([x, y, depth_map], dim=-1)


def unproject_depth_to_world(depth_map, extrinsics, intrinsics) -> torch.Tensor:
    """(..., H, W[, 1]) depth, (..., 3, 4) E, (..., 3, 3) K -> (..., H, W, 3) world."""
    if depth_map.shape[-1] == 1 and depth_map.dim() >= 3:
        depth_map = depth_map[..., 0]
    cam_pts = depth_to_cam_points(depth_map, intrinsics)
    c2w = se3_inverse(extrinsics)
    R = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    return torch.einsum("...ij,...hwj->...hwi", R, cam_pts) + t[..., None, None, :]
