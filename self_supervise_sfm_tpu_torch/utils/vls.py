"""Visualisations: depth colormaps, track overlays, correspondence
overlays, CDF/PDF curves and the bidirectional reprojection grid.

Port of ``self_supervise_sfm_tpu/utils/vls.py`` (numpy and matplotlib,
host-side only). matplotlib is imported, on its Agg backend, inside the
functions that draw.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def colorize_depth(depth: np.ndarray, vmin: Optional[float] = None,
                   vmax: Optional[float] = None, cmap: str = "magma") -> np.ndarray:
    """(H, W) depth -> (H, W, 3) uint8, the colormap over the 5th-95th
    percentiles of the valid (finite, positive) depths; invalid pixels 0."""
    plt = _pyplot()
    d = np.asarray(depth, np.float32)
    valid = np.isfinite(d) & (d > 0)
    if vmin is None:
        vmin = np.percentile(d[valid], 5) if valid.any() else 0.0
    if vmax is None:
        vmax = np.percentile(d[valid], 95) if valid.any() else 1.0
    norm = np.clip((d - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    out = (plt.get_cmap(cmap)(norm)[..., :3] * 255).astype(np.uint8)
    out[~valid] = 0
    return out


def visualize_tracks_on_images(images: np.ndarray, tracks: np.ndarray,
                               visibility: Optional[np.ndarray] = None,
                               out_dir: str = "track_visuals", max_tracks: int = 256):
    """One PNG a frame: up to ``max_tracks`` tracks (S, N, 2) drawn on the
    frames (S, H, W, 3), coloured by their position in the first frame;
    invisible points faint white. Returns the paths."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    S, N = tracks.shape[:2]
    H, W = np.asarray(images[0]).shape[:2]
    sel = np.linspace(0, N - 1, min(max_tracks, N)).astype(int)
    x0 = tracks[0, sel, 0] / max(W - 1, 1)
    y0 = tracks[0, sel, 1] / max(H - 1, 1)
    colors = plt.get_cmap("hsv")((x0 + y0) / 2.0)
    paths = []
    for s in range(S):
        fig, ax = plt.subplots(figsize=(6, 6 * H / W))
        ax.imshow(np.asarray(images[s]))
        pts = tracks[s, sel]
        vis = (visibility[s, sel].astype(bool) if visibility is not None
               else np.ones(len(sel), bool))
        ax.scatter(pts[vis, 0], pts[vis, 1], c=colors[vis], s=8)
        if (~vis).any():
            ax.scatter(pts[~vis, 0], pts[~vis, 1], c="white", s=4, alpha=0.4)
        ax.axis("off")
        path = os.path.join(out_dir, f"track_frame_{s:04d}.png")
        fig.savefig(path, dpi=110, bbox_inches="tight")
        plt.close(fig)
        paths.append(path)
    return paths


def correspondence_overlay(
    img_src: np.ndarray,
    img_dst: np.ndarray,
    src_coords: np.ndarray,
    dst_coords: np.ndarray,
    pred_dst_coords: Optional[np.ndarray] = None,
    num_show: int = 64,
    save_path: Optional[str] = None,
):
    """Side-by-side correspondence plot (mirrors ``corres2vls`` /
    ``tuple2vls``): measured matches in green, predicted reprojections in
    red with offset lines."""
    plt = _pyplot()
    rng = np.random.default_rng(0)
    n = src_coords.shape[0]
    sel = rng.choice(n, min(num_show, n), replace=False)
    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].imshow(np.asarray(img_src))
    axes[0].scatter(src_coords[sel, 0], src_coords[sel, 1], c="lime", s=6)
    axes[0].set_title("source")
    axes[1].imshow(np.asarray(img_dst))
    axes[1].scatter(dst_coords[sel, 0], dst_coords[sel, 1], c="lime", s=6,
                    label="measured")
    if pred_dst_coords is not None:
        axes[1].scatter(pred_dst_coords[sel, 0], pred_dst_coords[sel, 1],
                        c="red", s=6, label="reprojected")
        for i in sel:
            axes[1].plot(
                [dst_coords[i, 0], pred_dst_coords[i, 0]],
                [dst_coords[i, 1], pred_dst_coords[i, 1]],
                c="yellow", lw=0.5, alpha=0.6,
            )
        axes[1].legend(loc="lower right", fontsize=8)
    axes[1].set_title("destination")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def plot_cdf_pdf_curves(
    frame_cdfs: np.ndarray,
    frame_pdfs: np.ndarray,
    min_val: float,
    max_val: float,
    num_bins: int,
    save_path: str,
):
    """Per-frame CDF/PDF curve grid (the loss's frame statistics, for
    the trainer's artifact dumps)."""
    plt = _pyplot()
    frame_cdfs = np.asarray(frame_cdfs)
    frame_pdfs = np.asarray(frame_pdfs)
    n = frame_cdfs.shape[0]
    xs = np.linspace(min_val, max_val, num_bins)
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 7), squeeze=False)
    for f in range(n):
        axes[0, f].plot(xs, frame_cdfs[f], "b-")
        axes[0, f].set_title(f"frame {f}: CDF")
        axes[0, f].grid(alpha=0.3)
        axes[1, f].plot(xs, frame_pdfs[f], "r-")
        axes[1, f].set_title(f"frame {f}: PDF")
        axes[1, f].grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path


def reprojection_validation_grid(
    scene: dict,
    extrinsic: np.ndarray,  # (S, 3, 4) predicted, processed space
    intrinsic: np.ndarray,  # (S, 3, 3) predicted, processed space
    pair: Optional[int] = None,
    nlim: int = 24,
    save_path: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
):
    """3x2 bidirectional reprojection-validation grid: row 1 the measured
    correspondences, row 2 source points reprojected into the destination,
    row 3 destination points reprojected back into the source, with shared
    per-point colours so a correct relative pose shows every point landing
    on its same-coloured partner.

    ``nlim`` points are drawn at random. Correspondences live in ORIGINAL
    image space while ``scene["images"]`` are the processed (pad-square)
    frames, so every drawn point is mapped through the ``K_to_K_prime``
    affine first.
    """
    import torch

    from ..ops import geometry as G

    plt = _pyplot()
    rng = rng or np.random.default_rng(0)
    valid = np.flatnonzero(scene["pair_valid"] > 0)
    if len(valid) == 0:
        return None
    p = int(pair if pair is not None else rng.choice(valid))
    si, di = int(scene["src_idx"][p]), int(scene["dst_idx"][p])

    n = scene["src_coords"].shape[1]
    sel = rng.choice(n, min(nlim, n), replace=False)
    src = scene["src_coords"][p][sel]
    dst = scene["dst_coords"][p][sel]
    dep_s = scene["src_depth"][p][sel]
    dep_d = scene["dst_depth"][p][sel]
    recovered_K = scene["K_prime_to_K"] @ np.asarray(intrinsic)
    ones = torch.ones((1, len(sel)), dtype=torch.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731

    def reproject(a, b, coords, depth):
        rel = G.relative_pose(t(extrinsic[a: a + 1]), t(extrinsic[b: b + 1]))
        out, _ = G.backproject_and_reproject(
            t(coords[None]), t(depth[None]), t(recovered_K[a: a + 1]),
            t(recovered_K[b: b + 1]), rel, ones)
        return out[0].numpy()

    pred_dst = reproject(si, di, src, dep_s)   # src -> dst
    pred_src = reproject(di, si, dst, dep_d)   # dst -> src

    def to_processed(frame_idx, pts):
        A = scene["K_to_K_prime"][frame_idx]
        return pts * np.array([A[0, 0], A[1, 1]]) + np.array([A[0, 2], A[1, 2]])

    colors = plt.get_cmap("hsv")(np.linspace(0, 1, len(sel), endpoint=False))
    fig, axes = plt.subplots(3, 2, figsize=(10, 13))
    fig.suptitle(f"reprojection validation: pair {si} -> {di}")

    def draw(ax, frame_idx, pts, title):
        ax.imshow(np.asarray(scene["images"][frame_idx]))
        q = to_processed(frame_idx, pts)
        ax.scatter(q[:, 0], q[:, 1], s=36, c=colors, edgecolors="white",
                   linewidths=0.6)
        ax.set_title(title, fontsize=9)
        ax.axis("off")

    draw(axes[0, 0], si, src, "source (measured)")
    draw(axes[0, 1], di, dst, "destination (measured)")
    draw(axes[1, 0], si, src, "source points")
    draw(axes[1, 1], di, pred_dst, "reprojected into destination")
    draw(axes[2, 0], di, dst, "destination points")
    draw(axes[2, 1], si, pred_src, "reprojected into source")
    fig.tight_layout()
    if save_path is not None:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path, dpi=120)
    plt.close(fig)
    return save_path
