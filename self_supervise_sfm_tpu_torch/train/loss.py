"""Self-supervised training loss: the reprojection-residual CDF objective.

Port of ``self_supervise_sfm_tpu/train/loss.py``. Per scene: the predicted
intrinsics back in original image space through the loader's
``K_prime_to_K`` (averaged when the scene shares a focal), relative poses
of every correspondence pair, the correspondences reprojected exactly and
by the depth-linearised approximation, ``log1p`` residuals, the per-frame
CDF loss, and the mean of the exact and approximate masked means. Padded
pairs carry zero weight.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from ..ops import geometry as G
from ..ops.cdf_loss import CDFLossConfig, cdf_loss, frame_statistics


@dataclass(frozen=True)
class LossConfig:
    max_val: float = 15.0
    num_bins: int = 250
    gradient_smooth: float = 0.05
    min_val: float = 0.0
    shared_focal: bool = False

    def cdf_cfg(self, num_frames: int) -> CDFLossConfig:
        return CDFLossConfig(
            min_val=self.min_val, max_val=self.max_val, num_bins=self.num_bins,
            num_nodes=num_frames, gradient_smooth=self.gradient_smooth,
        )


def _masked_mean(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x * w).sum() / (w.sum() + 1e-10)


@G.f32_matmul
def scene_residuals(extrinsic, intrinsic, scene: Dict[str, torch.Tensor],
                    cfg: LossConfig) -> Dict[str, torch.Tensor]:
    """Reprojection residuals of one scene. extrinsic (S, 3, 4), intrinsic
    (S, 3, 3), both predicted in processed (518 px) space; ``scene`` holds
    one scene's entries of the batch. Returns raw and ``log1p`` residuals
    of both reprojections, the weights and the pair frame indices."""
    recovered_K = scene["K_prime_to_K"] @ intrinsic
    if cfg.shared_focal:
        recovered_K = recovered_K.mean(dim=0, keepdim=True).expand_as(recovered_K)
    src_idx, dst_idx = scene["src_idx"].long(), scene["dst_idx"].long()
    src_K, dst_K = recovered_K[src_idx], recovered_K[dst_idx]
    rel = G.relative_pose(extrinsic[src_idx], extrinsic[dst_idx])
    ones = torch.ones((src_idx.shape[0], 1), dtype=torch.float32, device=extrinsic.device)
    weights = scene["pair_valid"][:, None].expand(scene["src_depth"].shape).float()

    pred_dst, _ = G.backproject_and_reproject(
        scene["src_coords"], scene["src_depth"], src_K, dst_K, rel, ones)
    residuals = G.compute_projective_residual(pred_dst, scene["dst_coords"])
    pred_dst_a, _ = G.backproject_and_reproject_with_approximation(
        scene["src_coords"], scene["src_depth"], scene["dst_depth"], src_K, dst_K, rel,
        ones, ones)
    residuals_a = G.compute_projective_residual(pred_dst_a, scene["dst_coords"])
    return {
        "residuals": residuals, "residuals_approx": residuals_a,
        "res_log": torch.log1p(residuals), "res_a_log": torch.log1p(residuals_a),
        "weights": weights, "src_idx": src_idx, "dst_idx": dst_idx,
    }


def scene_cdf_statistics(extrinsic, intrinsic, scene: Dict[str, torch.Tensor],
                         cfg: LossConfig) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-frame (pmf, cdf, pdf) of the exact and the approximated residual
    distributions of one scene: ``{"exact": ..., "approx": ...}``, each
    ``{"frame_pmf", "frame_cdf", "frame_pdf"}`` of (S, num_bins)."""
    S = extrinsic.shape[0]
    r = scene_residuals(extrinsic, intrinsic, scene, cfg)
    ccfg = cfg.cdf_cfg(S)
    return {
        "exact": frame_statistics(r["res_log"], r["weights"], r["src_idx"],
                                  r["dst_idx"], ccfg),
        "approx": frame_statistics(r["res_a_log"], r["weights"], r["src_idx"],
                                   r["dst_idx"], ccfg),
    }


def scene_loss(extrinsic, intrinsic, scene: Dict[str, torch.Tensor],
               cfg: LossConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loss of one scene: (scalar loss, metrics)."""
    S = extrinsic.shape[0]
    r = scene_residuals(extrinsic, intrinsic, scene, cfg)
    weights = r["weights"]
    ccfg = cfg.cdf_cfg(S)
    cs, cd = cdf_loss(r["res_log"], weights, r["src_idx"], r["dst_idx"], ccfg)
    loss_exact = (_masked_mean(cs, weights) + _masked_mean(cd, weights)) / 2.0
    cs_a, cd_a = cdf_loss(r["res_a_log"], weights, r["src_idx"], r["dst_idx"], ccfg)
    loss_approx = (_masked_mean(cs_a, weights) + _masked_mean(cd_a, weights)) / 2.0
    total = (loss_exact + loss_approx) / 2.0
    metrics = {
        "loss": total,
        "loss_cdf_exact": loss_exact,
        "loss_cdf_approx": loss_approx,
        "mean_px_residual": _masked_mean(r["residuals"], weights),
        "mean_log_residual": _masked_mean(r["res_log"], weights),
    }
    # quantiles of the masked log residuals; torch.nanquantile's default
    # "linear" interpolation is jnp.nanpercentile's
    masked = torch.where(weights > 0, r["res_log"], torch.full_like(r["res_log"], float("nan")))
    q = torch.tensor([0.1, 0.5, 0.9], dtype=torch.float32, device=masked.device)
    p10, p50, p90 = torch.nanquantile(masked.detach().reshape(-1), q)
    metrics["log_residual_p10"] = p10
    metrics["log_residual_p50"] = p50
    metrics["log_residual_p90"] = p90
    return total, metrics
