"""Camera/pose geometry in fp32: poses, rotations, projection.

Port of ``self_supervise_sfm_tpu/ops/geometry.py``: pose encoding and
decoding, quaternion / axis-angle / matrix conversions, depth unprojection,
relative poses, the correspondence reprojection of the loss, and the
projection with radial distortion that the COLMAP export and the bundle
adjuster use. Extrinsics are OpenCV world-to-camera ``[R|t]`` (..., 3, 4);
quaternions are scalar-last xyzw; the pose encoding is ``[tx ty tz, qx qy qz
qw, fov_h fov_w]``. The JAX package pins these matmuls to full fp32 on the
TPU (``f32_matmul``); here :func:`f32_matmul` turns TF32 off for the
duration of a call, and the model entries turn it off for the same reason.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch


def f32_matmul(fn):
    """Run ``fn`` with TF32 off for matmuls and cuDNN (full fp32 products),
    restoring the previous settings after: the twin of the JAX package's
    ``f32_matmul`` (``ops/geometry.py:30-40``)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return wrapped


def to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    """Append a 1 to the last axis. (..., N) -> (..., N+1)."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def from_homogeneous(points: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Perspective divide, (..., N+1) -> (..., N): the denominator gets
    ``eps`` added (its sign kept) and exact zeros replaced by 1e-12."""
    denom = points[..., -1:] + eps
    denom = torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
    return points[..., :-1] / denom


def pad_poses(pose34: torch.Tensor) -> torch.Tensor:
    """Pad (..., 3, 4) to (..., 4, 4) with the row [0, 0, 0, 1]."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=pose34.dtype,
                          device=pose34.device)
    bottom = bottom.expand(*pose34.shape[:-2], 1, 4)
    return torch.cat([pose34[..., :3, :4], bottom], dim=-2)


def unpad_poses(pose44: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 3, 4)."""
    return pose44[..., :3, :4]


def as_pose44(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) -> (..., 4, 4)."""
    return pad_poses(pose) if pose.shape[-2:] == (3, 4) else pose


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


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that the scalar (last) component is non-negative."""
    return torch.where(quaternions[..., 3:4] < 0, -quaternions, quaternions)


def mat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix -> (..., 4) xyzw quaternion: of the four
    candidate quaternions the one with the largest denominator, picked with
    a one-hot sum as in the JAX package (ties go to the first)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = matrix.reshape(
        *matrix.shape[:-2], 9).unbind(-1)
    q_abs = torch.sqrt(torch.clamp(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1), min=0.0))
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    candidates = quat_by_rijk / (2.0 * torch.clamp(q_abs[..., None], min=0.1))
    onehot = torch.nn.functional.one_hot(q_abs.argmax(-1), 4).to(matrix.dtype)
    out = (candidates * onehot[..., None]).sum(-2)  # rijk
    return standardize_quaternion(out[..., [1, 2, 3, 0]])


def axis_angle_to_mat(aa: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues), smooth at 0."""
    theta2 = (aa * aa).sum(-1, keepdim=True)[..., None]  # (..., 1, 1)
    theta = torch.sqrt(theta2 + 1e-24)
    x, y, z = aa.unbind(-1)
    zeros = torch.zeros_like(x)
    K = torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(K.shape)
    a = torch.sinc(theta / torch.pi)  # sin(theta) / theta
    b = torch.where(theta2 > 1e-12, (1.0 - torch.cos(theta)) / (theta2 + 1e-24),
                    torch.full_like(theta2, 0.5))
    return eye + a * K + b * (K @ K)


def mat_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle via the quaternion."""
    q = mat_to_quat(R)  # xyzw, w >= 0
    xyz = q[..., :3]
    w = torch.clamp(q[..., 3:4], -1.0, 1.0)
    n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    theta = 2.0 * torch.atan2(n, w)
    scale = torch.where(n > 1e-9, theta / torch.clamp(n, min=1e-12),
                        torch.full_like(n, 2.0))
    return xyz * scale


def extri_intri_to_pose_encoding(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                                 image_size_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 3, 4), (..., 3, 3) -> (..., 9) ``[t, quat xyzw, fov_h, fov_w]``."""
    quat = mat_to_quat(extrinsics[..., :3, :3])
    H, W = image_size_hw
    fov_h = 2.0 * torch.atan((H / 2.0) / intrinsics[..., 1, 1])
    fov_w = 2.0 * torch.atan((W / 2.0) / intrinsics[..., 0, 0])
    return torch.cat([extrinsics[..., :3, 3], quat, fov_h[..., None], fov_w[..., None]],
                     dim=-1)


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


# -- correspondence reprojection (the training-loss geometry) ----------------


@f32_matmul
def relative_pose(src_extrinsic: torch.Tensor, dst_extrinsic: torch.Tensor) -> torch.Tensor:
    """src-cam -> dst-cam transform ``dst @ inv(src)``, (..., 4, 4)."""
    return as_pose44(dst_extrinsic) @ se3_inverse(as_pose44(src_extrinsic))


def _reproject(src_coords, scaled_depth, src_intrinsic, dst_intrinsic, rel_pose):
    """Back-project src pixels at ``scaled_depth`` and map them into the dst
    camera: the homogeneous dst pixel coordinates (P, N, 3)."""
    rel44 = as_pose44(rel_pose)
    src_h = to_homogeneous(src_coords)
    K_inv = torch.linalg.inv(src_intrinsic)
    cam = torch.einsum("...ij,...nj->...ni", K_inv, src_h) * scaled_depth[..., None]
    dst_cam = torch.einsum("...ij,...nj->...ni", rel44, to_homogeneous(cam))[..., :3]
    return torch.einsum("...ij,...nj->...ni", dst_intrinsic, dst_cam)


@f32_matmul
def backproject_and_reproject(src_coords, src_depth, src_intrinsic, dst_intrinsic,
                              rel_pose, src_depth_scale):
    """Exact perspective reprojection of src pixels into the dst view.
    src_coords (P, N, 2), src_depth (P, N), intrinsics (P, 3, 3), rel_pose
    (P, 3|4, 4), src_depth_scale (P, 1) -> (dst_coords (P, N, 2), valid
    (P, N), all True)."""
    dst_h = _reproject(src_coords, src_depth * src_depth_scale, src_intrinsic,
                       dst_intrinsic, rel_pose)
    dst = from_homogeneous(dst_h)
    return dst, torch.ones(dst.shape[:-1], dtype=torch.bool, device=dst.device)


@f32_matmul
def backproject_and_reproject_with_approximation(
        src_coords, src_depth, dst_depth, src_intrinsic, dst_intrinsic, rel_pose,
        src_depth_scale, dst_depth_scale):
    """Linearised reprojection: the perspective division by the measured
    destination depth instead of the reprojected one."""
    dst_h = _reproject(src_coords, src_depth * src_depth_scale, src_intrinsic,
                       dst_intrinsic, rel_pose)
    scaled_dst = dst_depth * dst_depth_scale
    dst = dst_h[..., :2] / (scaled_dst[..., None] + 1e-6)
    return dst, torch.ones(dst.shape[:-1], dtype=torch.bool, device=dst.device)


def compute_projective_residual(predicted_dst_coords, actual_dst_coords):
    """Per-point L2 residual, (..., N, 2) x2 -> (..., N)."""
    return torch.linalg.vector_norm(predicted_dst_coords - actual_dst_coords, dim=-1)


# -- projection with radial distortion (the COLMAP camera models) ------------


def apply_distortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """SIMPLE_RADIAL ([k]), RADIAL ([k1, k2]) or OPENCV ([k1, k2, p1, p2])
    distortion of normalised coordinates; ``params`` (..., NP)."""
    num_params = params.shape[-1]
    r2 = u * u + v * v
    if num_params == 1:
        radial = params[..., 0] * r2
        du, dv = u * radial, v * radial
    elif num_params == 2:
        k1, k2 = params[..., 0], params[..., 1]
        radial = k1 * r2 + k2 * r2 * r2
        du, dv = u * radial, v * radial
    elif num_params == 4:
        k1, k2, p1, p2 = params.unbind(-1)
        uv = u * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2.0 * p1 * uv + p2 * (r2 + 2.0 * u * u)
        dv = v * radial + 2.0 * p2 * uv + p1 * (r2 + 2.0 * v * v)
    else:
        raise ValueError(f"Unsupported number of distortion params: {num_params}")
    return u + du, v + dv


def iterative_undistortion(params: torch.Tensor, uv: torch.Tensor,
                           max_iters: int = 100) -> torch.Tensor:
    """Newton undistortion with a central-difference Jacobian, a fixed
    ``max_iters`` steps; a point whose step falls under 1e-10 stops moving."""
    eps = torch.finfo(uv.dtype).eps
    xy = uv
    for _ in range(max_iters):
        x, y = xy[..., 0], xy[..., 1]
        fx, fy = apply_distortion(params, x, y)
        fx = fx - uv[..., 0]
        fy = fy - uv[..., 1]
        step_x = torch.clamp((1e-6 * x).abs(), min=eps)
        step_y = torch.clamp((1e-6 * y).abs(), min=eps)
        fx_px, fy_px = apply_distortion(params, x + step_x, y)
        fx_mx, fy_mx = apply_distortion(params, x - step_x, y)
        fx_py, fy_py = apply_distortion(params, x, y + step_y)
        fx_my, fy_my = apply_distortion(params, x, y - step_y)
        J00 = (fx_px - fx_mx) / (2.0 * step_x)
        J01 = (fx_py - fx_my) / (2.0 * step_y)
        J10 = (fy_px - fy_mx) / (2.0 * step_x)
        J11 = (fy_py - fy_my) / (2.0 * step_y)
        det = J00 * J11 - J01 * J10
        # a sign-keeping floor: a step through a zero determinant stays finite
        det = torch.where(det.abs() < 1e-12,
                          torch.where(det < 0, -1e-12, 1e-12).to(det.dtype), det)
        dx = (J11 * fx - J01 * fy) / det
        dy = (-J10 * fx + J00 * fy) / det
        keep = dx * dx + dy * dy >= 1e-10
        xy = torch.stack([x - torch.where(keep, dx, 0.0), y - torch.where(keep, dy, 0.0)],
                         dim=-1)
    return xy


@f32_matmul
def img_from_cam(intrinsics: torch.Tensor, points_cam: torch.Tensor,
                 distortion_params: Optional[torch.Tensor] = None,
                 default: float = 0.0) -> torch.Tensor:
    """Camera-frame points (B, 3, N) -> pixels (B, N, 2) through (B, 3, 3)
    intrinsics and optional (B, NP) distortion; non-finite pixels become
    ``default``."""
    pts = points_cam / (points_cam[:, 2:3, :] + 1e-8)
    if distortion_params is not None:
        u, v = apply_distortion(distortion_params[..., None, :], pts[:, 0], pts[:, 1])
        pts = torch.stack([u, v, torch.ones_like(u)], dim=1)
    pix = torch.einsum("bij,bjn->bin", intrinsics, pts)[:, :2].transpose(-1, -2)
    return torch.where(torch.isfinite(pix), pix, torch.full_like(pix, default))


@f32_matmul
def project_world_points_to_cam(world_points: torch.Tensor, cam_extrinsics: torch.Tensor,
                                cam_intrinsics: Optional[torch.Tensor] = None,
                                distortion_params: Optional[torch.Tensor] = None,
                                default: float = 0.0):
    """World points (N, 3) -> (pixels (B, N, 2) or None, camera points
    (B, 3, N)) for (B, 3, 4) extrinsics."""
    cam_points = torch.einsum("bij,nj->bin", cam_extrinsics, to_homogeneous(world_points))
    if cam_intrinsics is None:
        return None, cam_points
    return img_from_cam(cam_intrinsics, cam_points, distortion_params, default), cam_points
