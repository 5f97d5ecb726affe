"""Trajectory evaluation: Sim(3) alignment + ATE / RPE metrics.

Port of ``self_supervise_sfm_tpu/utils/evaluation.py`` (numpy in both
packages): Umeyama similarity alignment of predicted and ground-truth camera
centres, the absolute trajectory error, the relative rotation / translation
angles over all ordered frame pairs, and the AUC of the pose-error recall
curve.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def camera_centers(extrinsics_w2c: np.ndarray) -> np.ndarray:
    """(..., 3|4, 4) or (..., 3, 4) world-to-cam -> (..., 3) centres -R^T t."""
    E = np.asarray(extrinsics_w2c)
    R = E[..., :3, :3]
    t = E[..., :3, 3]
    return -np.einsum("...ji,...j->...i", R, t)


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Similarity transform (s, R, t) minimising ||s R src + t - dst||.

    src/dst: (N, 3). Returns (s, R (3,3), t (3,)).
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_s) if var_s > 0 else 1.0
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def absolute_trajectory_error(
    pred_w2c: np.ndarray, gt_w2c: np.ndarray, with_scale: bool = True
) -> Dict[str, float]:
    """Sim(3)-aligned ATE over camera centres. Returns rmse/mean/median."""
    cp = camera_centers(pred_w2c)
    cg = camera_centers(gt_w2c)
    s, R, t = umeyama_alignment(cp, cg, with_scale)
    aligned = (s * (R @ cp.T)).T + t
    err = np.linalg.norm(aligned - cg, axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "scale": float(s),
    }


def relative_rotation_angles_deg(pred_w2c: np.ndarray, gt_w2c: np.ndarray):
    """Pairwise relative-rotation error (degrees) over all ordered pairs."""
    Rp = np.asarray(pred_w2c)[..., :3, :3]
    Rg = np.asarray(gt_w2c)[..., :3, :3]
    n = Rp.shape[0]
    errs = []
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            rel_p = Rp[j] @ Rp[i].T
            rel_g = Rg[j] @ Rg[i].T
            dR = rel_p @ rel_g.T
            cos = np.clip((np.trace(dR) - 1) / 2, -1, 1)
            errs.append(np.degrees(np.arccos(cos)))
    return np.asarray(errs)


def relative_translation_angles_deg(pred_w2c: np.ndarray, gt_w2c: np.ndarray):
    """Pairwise relative-translation direction error (degrees)."""

    def rel_t(E, i, j):
        Ri, ti = E[i, :3, :3], E[i, :3, 3]
        Rj, tj = E[j, :3, :3], E[j, :3, 3]
        return tj - Rj @ Ri.T @ ti

    Ep = np.asarray(pred_w2c)
    Eg = np.asarray(gt_w2c)
    n = Ep.shape[0]
    errs = []
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            a = rel_t(Ep, i, j)
            b = rel_t(Eg, i, j)
            na, nb = np.linalg.norm(a), np.linalg.norm(b)
            if na < 1e-9 or nb < 1e-9:
                continue
            cos = np.clip(a @ b / (na * nb), -1, 1)
            errs.append(np.degrees(np.arccos(cos)))
    return np.asarray(errs)


# numpy 2 renamed trapz to trapezoid
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def pose_auc(errors_deg: np.ndarray, thresholds=(5, 10, 20)) -> Dict[str, float]:
    """AUC of the pose-error recall curve at the given degree thresholds."""
    errors = np.sort(np.asarray(errors_deg))
    n = len(errors)
    out = {}
    for th in thresholds:
        recall = np.searchsorted(errors, np.linspace(0, th, 100)) / max(n, 1)
        out[f"auc@{th}"] = float(_trapezoid(recall, dx=1.0 / 99))
    return out
