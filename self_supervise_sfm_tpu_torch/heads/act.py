"""Head activations — port of ``self_supervise_sfm_tpu/heads/act.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    """sign(y) * (exp(|y|) - 1)."""
    return torch.sign(y) * torch.expm1(torch.abs(y))


def base_pose_act(pose_enc: torch.Tensor, act_type: str = "linear") -> torch.Tensor:
    if act_type == "linear":
        return pose_enc
    if act_type == "inv_log":
        return inverse_log_transform(pose_enc)
    if act_type == "exp":
        return torch.exp(pose_enc)
    if act_type == "relu":
        return F.relu(pose_enc)
    raise ValueError(f"Unknown act_type: {act_type}")


def activate_pose(pred_pose_enc, trans_act="linear", quat_act="linear", fl_act="linear"):
    """Activate the [T(3), quat(4), fov(2)] slices."""
    T = base_pose_act(pred_pose_enc[..., :3], trans_act)
    quat = base_pose_act(pred_pose_enc[..., 3:7], quat_act)
    fl = base_pose_act(pred_pose_enc[..., 7:], fl_act)
    return torch.cat([T, quat, fl], dim=-1)


def activate_head(out: torch.Tensor, activation: str = "norm_exp",
                  conf_activation: str = "expp1"):
    """Split NHWC head output into (values, confidence) with activations;
    the last channel is the confidence logit."""
    xyz = out[..., :-1]
    conf = out[..., -1]

    if activation == "norm_exp":
        d = torch.clamp(torch.linalg.norm(xyz, dim=-1, keepdim=True), min=1e-8)
        pts = (xyz / d) * torch.expm1(d)
    elif activation == "norm":
        pts = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    elif activation == "exp":
        pts = torch.exp(xyz)
    elif activation == "relu":
        pts = F.relu(xyz)
    elif activation == "inv_log":
        pts = inverse_log_transform(xyz)
    elif activation == "xy_inv_log":
        xy, z = xyz[..., :2], xyz[..., 2:]
        z = inverse_log_transform(z)
        pts = torch.cat([xy * z, z], dim=-1)
    elif activation == "sigmoid":
        pts = torch.sigmoid(xyz)
    elif activation == "linear":
        pts = xyz
    else:
        raise ValueError(f"Unknown activation: {activation}")

    if conf_activation == "expp1":
        conf_out = 1.0 + torch.exp(conf)
    elif conf_activation == "expp0":
        conf_out = torch.exp(conf)
    elif conf_activation == "sigmoid":
        conf_out = torch.sigmoid(conf)
    else:
        raise ValueError(f"Unknown conf_activation: {conf_activation}")
    return pts, conf_out
