"""Per-frame CDF loss: the self-supervised training objective.

Port of ``self_supervise_sfm_tpu/ops/cdf_loss.py``. Every correspondence
residual adds its weight to the histograms of its source and destination
frames; a histogram over each frame's total weight is a PMF, its cumsum the
CDF, and a reflect-padded Sobel derivative of the CDF, smoothed by a
reflect-padded Gaussian, the PDF. A residual's loss value is its frame's CDF
at its (+0.5-rounded) bin, and its gradient is the injected
``PDF * weight`` (the ``custom_vjp`` becomes a ``torch.autograd.Function``),
not autograd of the lookup. Out-of-range residuals get CDF = 2.0 and zero
gradient.

The histograms are built with ``index_add_``, which sums with atomics on a
CUDA device: their low bits may differ from run to run there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class CDFLossConfig:
    min_val: float
    max_val: float
    num_bins: int
    num_nodes: int  # number of frames
    gradient_smooth: float = 0.0001  # physical smoothing radius on the x-axis

    @property
    def bin_width(self) -> float:
        return (self.max_val - self.min_val) / self.num_bins

    @property
    def smooth_kernel(self) -> np.ndarray:
        """Gaussian smoothing kernel (identity if smoothing is off)."""
        if self.gradient_smooth <= 0:
            return np.ones((1,), np.float32)
        radius = max(1, int(self.gradient_smooth / self.bin_width))
        idx = np.arange(2 * radius + 1, dtype=np.float32) - radius
        sigma = self.gradient_smooth / self.bin_width
        g = np.exp(-0.5 * (idx / sigma) ** 2)
        return (g / g.sum()).astype(np.float32)


def _reflect_correlate(rows: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Cross-correlate each row of (N, B) with an odd-length ``kernel`` under
    reflect padding (the edge sample is not repeated, as ``jnp.pad(...,
    mode="reflect")``)."""
    K = kernel.shape[0]
    if K == 1:
        return rows * kernel[0]
    r = K // 2
    padded = torch.cat([rows[:, 1: r + 1].flip(-1), rows,
                        rows[:, -r - 1: -1].flip(-1)], dim=1)
    return (padded.unfold(1, K, 1) * kernel).sum(-1)


def compute_pdf_cdf(residuals, weights, src_idx, dst_idx, cfg: CDFLossConfig):
    """Per-frame (pmf, cdf, pdf), each (num_nodes, num_bins).
    residuals / weights: (P, K); src_idx / dst_idx: (P,) frame ids."""
    P, K = residuals.shape
    dev = residuals.device
    bw = cfg.bin_width
    bins = torch.floor((residuals - cfg.min_val) / bw).long()
    valid = (bins >= 0) & (bins < cfg.num_bins)
    bins = bins.clamp(0, cfg.num_bins - 1)
    contrib = (weights * valid).reshape(-1)
    flat_bins = bins.reshape(-1)
    src_pt = src_idx.long().repeat_interleave(K)
    dst_pt = dst_idx.long().repeat_interleave(K)

    hist = torch.zeros(cfg.num_nodes * cfg.num_bins, dtype=torch.float32, device=dev)
    hist.index_add_(0, src_pt * cfg.num_bins + flat_bins, contrib)
    hist.index_add_(0, dst_pt * cfg.num_bins + flat_bins, contrib)
    hist = hist.reshape(cfg.num_nodes, cfg.num_bins)
    total = torch.zeros(cfg.num_nodes, dtype=torch.float32, device=dev)
    w_flat = weights.reshape(-1).float()
    total.index_add_(0, src_pt, w_flat)
    total.index_add_(0, dst_pt, w_flat)

    pmf = hist / (total[:, None] + 1e-10)
    cdf = torch.cumsum(pmf, dim=1)
    sobel = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float32, device=dev) / (2.0 * bw)
    raw_pdf = _reflect_correlate(cdf, sobel)
    pdf = _reflect_correlate(raw_pdf, torch.from_numpy(cfg.smooth_kernel).to(dev))
    return pmf, cdf, pdf


def _lookup(residuals, weights, src_idx, dst_idx, cdf, pdf, cfg: CDFLossConfig):
    """CDF value and injected gradient of every residual, each (P, K)."""
    bins = torch.floor((residuals - cfg.min_val) / cfg.bin_width + 0.5).long()
    valid = (bins >= 0) & (bins < cfg.num_bins) & (weights > 0.0)
    bins = bins.clamp(0, cfg.num_bins - 1)
    flat_cdf, flat_pdf = cdf.reshape(-1), pdf.reshape(-1)
    src_g = src_idx.long()[:, None] * cfg.num_bins + bins
    dst_g = dst_idx.long()[:, None] * cfg.num_bins + bins
    two, zero = torch.tensor(2.0, device=cdf.device), torch.tensor(0.0, device=cdf.device)
    cdf_src = torch.where(valid, flat_cdf[src_g], two)
    cdf_dst = torch.where(valid, flat_cdf[dst_g], two)
    grad_src = torch.where(valid, flat_pdf[src_g] * weights, zero)
    grad_dst = torch.where(valid, flat_pdf[dst_g] * weights, zero)
    return cdf_src, cdf_dst, grad_src, grad_dst


class _CDFLoss(torch.autograd.Function):
    """d(cdf_src, cdf_dst) / d residuals is the injected (pdf_src * g_src +
    pdf_dst * g_dst) * weight; the weights and indices get no gradient."""

    @staticmethod
    def forward(ctx, residuals, weights, src_idx, dst_idx, cfg):
        _, cdf, pdf = compute_pdf_cdf(residuals, weights, src_idx, dst_idx, cfg)
        cdf_src, cdf_dst, grad_src, grad_dst = _lookup(
            residuals, weights, src_idx, dst_idx, cdf, pdf, cfg)
        ctx.save_for_backward(grad_src, grad_dst)
        return cdf_src, cdf_dst

    @staticmethod
    def backward(ctx, g_src, g_dst):
        grad_src, grad_dst = ctx.saved_tensors
        return grad_src * g_src + grad_dst * g_dst, None, None, None, None


def cdf_loss(residuals, weights, src_idx, dst_idx, cfg: CDFLossConfig):
    """Per-residual CDF values (cdf_src, cdf_dst), each (P, K), with the
    injected PDF gradient."""
    return _CDFLoss.apply(residuals, weights.detach(), src_idx, dst_idx, cfg)


def frame_statistics(residuals, weights, src_idx, dst_idx, cfg: CDFLossConfig):
    """Per-frame pmf / cdf / pdf for diagnostics."""
    pmf, cdf, pdf = compute_pdf_cdf(residuals, weights, src_idx, dst_idx, cfg)
    return {"frame_pmf": pmf, "frame_cdf": cdf, "frame_pdf": pdf}
