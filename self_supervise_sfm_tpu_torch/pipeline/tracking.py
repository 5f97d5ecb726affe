"""Track prediction pipeline: query-frame selection, keypoints, tracking,
triangulation and bundle adjustment.

Port of ``self_supervise_sfm_tpu/pipeline/tracking.py``:

- :func:`rank_frames_by_dino`: query frames ranked by the DINOv2 CLS tokens
  of the port's ViT (cosine similarity, most central frame first, then
  farthest-point sampling);
- :func:`extract_keypoints`: Shi-Tomasi corners with grid NMS (numpy);
- :func:`predict_tracks`: per query frame, keypoints tracked through every
  frame in chunks by the VGGSfM tracker on the device, then frames that too
  few tracks see re-tracked as queries;
- :func:`triangulate_tracks`: linear (DLT) multi-view triangulation, every
  track at once as one batched float64 SVD on the host;
- :func:`tracks_to_reconstruction`: triangulation, the COLMAP gating and
  bundle adjustment on either engine: ``"torch"`` (``ops/bundle_adjust.py``
  on the device) or ``"native"`` (the C++ engine, ``native/ba.py``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..layers.vit import ViTConfig, vit_forward
from ..models.sailrecon import _device


@torch.no_grad()
def rank_frames_by_dino(vit_params, vit_cfg: ViTConfig, images, query_frame_num: int,
                        compute_dtype=torch.float32) -> List[int]:
    """images (S, H, W, 3) in [0, 1], on the params' device -> ranked
    representative frame indices."""
    images = torch.as_tensor(images)
    mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
    std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
    feats = vit_forward(vit_params, (images - mean) / std, vit_cfg,
                        compute_dtype)["x_norm_clstoken"].float()
    feats = feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    sim = (feats @ feats.T).cpu().numpy()
    dist = np.clip(100.0 - sim, 0, None)
    np.fill_diagonal(sim, -100.0)
    start = int(np.argmax(sim.sum(axis=1)))
    return farthest_point_sampling(dist, query_frame_num, start)


def farthest_point_sampling(
    distance_matrix: np.ndarray, num_samples: int, start_index: int = 0
) -> List[int]:
    """``vggsfm_utils.py:131-163`` — numpy."""
    dm = np.clip(np.asarray(distance_matrix, np.float64), 0, None)
    N = dm.shape[0]
    selected = [start_index]
    check = dm[start_index].copy()
    check[selected] = 0
    while len(selected) < min(num_samples, N):
        far = int(np.argmax(check))
        selected.append(far)
        check = dm[far].copy()
        check[selected] = 0
    return selected


# -- keypoint extraction (Shi-Tomasi corner response + grid NMS) --------------


def extract_keypoints(
    image: np.ndarray,  # (H, W, 3) in [0,1]
    max_pts: int = 2048,
    nms_radius: int = 4,
    border: int = 8,
) -> np.ndarray:
    """Shi-Tomasi corner keypoints (N, 2) xy with grid NMS (numpy): the
    tracker needs well-spread, textured query points."""
    img = np.asarray(image, np.float32)
    gray = img.mean(-1) if img.ndim == 3 else img
    H, W = gray.shape
    gx = np.zeros_like(gray)
    gy = np.zeros_like(gray)
    gx[:, 1:-1] = (gray[:, 2:] - gray[:, :-2]) / 2
    gy[1:-1] = (gray[2:] - gray[:-2]) / 2

    def box(x, r=2):
        k = 2 * r + 1
        c = np.cumsum(np.cumsum(np.pad(x, ((r + 1, r), (r + 1, r))), 0), 1)
        return (
            c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
        ) / (k * k)

    Ixx, Iyy, Ixy = box(gx * gx), box(gy * gy), box(gx * gy)
    # Shi-Tomasi min eigenvalue
    tr = Ixx + Iyy
    det = Ixx * Iyy - Ixy * Ixy
    disc = np.sqrt(np.maximum(tr * tr / 4 - det, 0))
    response = tr / 2 - disc
    response[:border] = response[-border:] = 0
    response[:, :border] = response[:, -border:] = 0

    # grid NMS: keep the max per (2r+1) cell
    r = nms_radius
    gh, gw = H // (2 * r + 1), W // (2 * r + 1)
    ys, xs, scores = [], [], []
    cells = response[: gh * (2 * r + 1), : gw * (2 * r + 1)].reshape(
        gh, 2 * r + 1, gw, 2 * r + 1
    ).transpose(0, 2, 1, 3).reshape(gh, gw, -1)
    best = cells.argmax(-1)
    score = cells.max(-1)
    cy = best // (2 * r + 1) + np.arange(gh)[:, None] * (2 * r + 1)
    cx = best % (2 * r + 1) + np.arange(gw)[None, :] * (2 * r + 1)
    order = np.argsort(score.ravel())[::-1][:max_pts]
    pts = np.stack([cx.ravel()[order], cy.ravel()[order]], axis=-1)
    keep = score.ravel()[order] > 1e-6
    return pts[keep].astype(np.float32)


# -- end-to-end track prediction ---------------------------------------------


def predict_tracks(
    tracker_params,
    images: np.ndarray,  # (S, H, W, 3) in [0, 1], one scene
    query_frame_indexes: Optional[List[int]] = None,
    query_frame_num: int = 3,
    max_query_pts: int = 2048,
    max_points_per_chunk: int = 1024,
    extractor_methods: str = "shi_tomasi",
    superpoint_params=None,
    fine_tracking: bool = True,
    augment_min_vis_frac: float = 0.3,
    max_augment_frames: int = 2,
    vit_params=None,
    vit_cfg=None,
    tracker_cfg=None,
    device="cuda",
    timings: Optional[dict] = None,
):
    """End-to-end track generation on ``device`` (``cuda`` unless asked for
    ``cpu``):

    1. query frames: the caller's, or the DINO ranking when ViT params are
       given, else spread uniformly;
    2. per query frame: the frames reordered so that it leads, keypoints of
       the extractor union, tracked through every frame in chunks of
       ``max_points_per_chunk``;
    3. frames whose share of visible tracks is under
       ``augment_min_vis_frac`` re-tracked with them as the query.

    Returns (tracks (S, N, 2), visibility (S, N), query points (N, 2)) as
    numpy arrays, in the original frame order, or None without keypoints.
    ``timings``: a dict to which the seconds of the keypoints and of the
    tracker's coarse and fine stages are added.
    """
    from .extractors import extract_keypoints_union, initialize_feature_extractors
    from .vggsfm_tracker import VGGSfMTrackerConfig, track as run_tracker

    dev = _device(device)
    S = images.shape[0]
    cfg = tracker_cfg or VGGSfMTrackerConfig()
    zoo = initialize_feature_extractors(extractor_methods, max_pts=max_query_pts,
                                        superpoint_params=superpoint_params, device=dev)
    if query_frame_indexes is None:
        if vit_params is not None and vit_cfg is not None:
            query_frame_indexes = rank_frames_by_dino(
                vit_params, vit_cfg, torch.from_numpy(np.asarray(images)).to(dev),
                query_frame_num)
        else:
            query_frame_indexes = list(np.linspace(0, S - 1, query_frame_num).astype(int))

    def forward_on_query(qidx: int):
        order = [qidx] + [i for i in range(S) if i != qidx]
        inv = np.argsort(order)
        imgs = torch.from_numpy(np.ascontiguousarray(images[order])).to(dev)[None]
        t0 = time.perf_counter()
        xy = extract_keypoints_union(images[qidx], zoo)[:max_query_pts]
        if timings is not None:
            timings["keypoints"] = timings.get("keypoints", 0.0) + time.perf_counter() - t0
        if len(xy) == 0:
            return None
        tr_chunks, vis_chunks = [], []
        for lo in range(0, len(xy), max_points_per_chunk):
            q = torch.from_numpy(xy[lo: lo + max_points_per_chunk]).to(dev)[None]
            fine, _, vis = run_tracker(tracker_params, imgs, q, cfg,
                                       fine_tracking=fine_tracking, device=dev,
                                       timings=timings)
            tr_chunks.append(fine[0].cpu().numpy())
            vis_chunks.append(vis[0].cpu().numpy())
        tr = np.concatenate(tr_chunks, axis=1)[inv]  # back to the original order
        vis = np.concatenate(vis_chunks, axis=1)[inv]
        return tr, vis, xy

    outs = [o for o in (forward_on_query(q) for q in query_frame_indexes) if o]
    if not outs:
        return None
    tracks = np.concatenate([o[0] for o in outs], axis=1)
    vis = np.concatenate([o[1] for o in outs], axis=1)
    qpts = np.concatenate([o[2] for o in outs], axis=0)

    # frames that too few tracks see become query frames themselves
    seen = set(query_frame_indexes)
    frame_vis = (vis > 0.5).mean(axis=1)
    bad = [i for i in np.argsort(frame_vis)
           if frame_vis[i] < augment_min_vis_frac and i not in seen][:max_augment_frames]
    for b in bad:
        o = forward_on_query(int(b))
        if o is not None:
            tracks = np.concatenate([tracks, o[0]], axis=1)
            vis = np.concatenate([vis, o[1]], axis=1)
            qpts = np.concatenate([qpts, o[2]], axis=0)
    return tracks, vis, qpts


# -- track -> reconstruction --------------------------------------------------


def triangulate_tracks(
    tracks: np.ndarray,  # (S, N, 2)
    vis: np.ndarray,  # (S, N) bool / float
    extrinsics: np.ndarray,  # (S, 3, 4)
    intrinsics: np.ndarray,  # (S, 3, 3)
) -> np.ndarray:
    """Linear (DLT) multi-view triangulation of every track -> (N, 3) fp32.

    The JAX package solves one SVD a track; here the tracks' (2S, 4)
    systems, with the rows of unseen frames zeroed (which leaves A^T A and
    so the null vector as they were), go through one batched float64 SVD.
    A track seen in fewer than two frames (< 4 rows) stays at 0; the
    homogeneous divide keeps the 1e-12 guard.
    """
    S, N, _ = tracks.shape
    Ps = np.einsum("sij,sjk->sik", intrinsics, extrinsics).astype(np.float64)
    vis = vis > 0.5 if vis.dtype != bool else vis
    t = np.asarray(tracks, np.float64).transpose(1, 0, 2)  # (N, S, 2)
    rows = np.stack([t[..., 0:1] * Ps[None, :, 2] - Ps[None, :, 0],
                     t[..., 1:2] * Ps[None, :, 2] - Ps[None, :, 1]], axis=2)  # (N, S, 2, 4)
    A = (rows * vis.T[:, :, None, None]).reshape(N, 2 * S, 4)
    pts = np.zeros((N, 3), np.float64)
    ok = 2 * vis.sum(axis=0) >= 4
    if ok.any():
        _, _, Vt = np.linalg.svd(A[ok], full_matrices=False)
        X = Vt[:, -1]
        w = np.where(np.abs(X[:, 3]) > 1e-12, X[:, 3], 1e-12)
        pts[ok] = X[:, :3] / w[:, None]
    return pts.astype(np.float32)


def tracks_to_reconstruction(
    tracks: np.ndarray,  # (S, N, 2)
    vis: np.ndarray,  # (S, N)
    extrinsics: np.ndarray,  # (S, 3, 4) initial (e.g. model-predicted)
    intrinsics: np.ndarray,  # (S, 3, 3)
    image_size: Tuple[int, int],
    max_reproj_error: float = 8.0,
    run_ba: bool = True,
    ba_engine: str = "torch",
    ba_num_shards: int = 1,
    colors: Optional[np.ndarray] = None,
    device="cuda",
    timings: Optional[dict] = None,
):
    """Tracked correspondences + initial poses -> a bundle-adjusted
    Reconstruction, or None when the gating leaves no point.

    ``ba_engine``: ``"torch"`` runs ``colmap_io.refine`` (LM, 20 steps,
    Huber 4 px) on ``device`` (``cuda`` unless asked for ``cpu``);
    ``"native"`` the C++ engine on the host, sharded over ``ba_num_shards``
    workers when that is > 1. Each engine runs only when asked for.
    ``timings``: a dict to which the seconds of the triangulation (with the
    gating) and of the engine's solve (``ba_torch`` / ``ba_native``) are
    added.
    """
    from ..utils import colmap_io as CIO

    if ba_engine not in ("torch", "native"):
        raise ValueError(f"ba_engine must be 'torch' or 'native', got {ba_engine!r}")
    dev = _device(device) if run_ba and ba_engine == "torch" else None
    timings = {} if timings is None else timings
    t0 = time.perf_counter()
    points3d = triangulate_tracks(tracks, vis, extrinsics, intrinsics)
    masks = ((vis > 0.5) & np.isfinite(points3d).all(-1)[None]
             & (np.abs(points3d).sum(-1) > 0)[None])
    rec, _ = CIO.batch_matrix_to_reconstruction(
        points3d, None, tracks, masks, extrinsics, intrinsics,
        image_size=image_size, max_reproj_error=max_reproj_error, colors=colors,
    )
    timings["triangulation"] = timings.get("triangulation", 0.0) + time.perf_counter() - t0
    if rec is None or not run_ba:
        return rec
    t0 = time.perf_counter()
    if ba_engine == "torch":
        from ..ops.bundle_adjust import BAConfig

        rec = CIO.refine(rec, BAConfig(max_iters=20, huber_delta=4.0), device=dev)
        timings["ba_torch"] = timings.get("ba_torch", 0.0) + time.perf_counter() - t0
        return rec
    from ..native import ba as NBA

    pts, exts, Ks = CIO.reconstruction_to_batch_matrix(rec)
    pids, iids, ci, pi, uv = CIO.observations(rec)
    args = (exts.astype(np.float32), Ks.astype(np.float32), pts.astype(np.float32),
            ci, pi, uv)
    if ba_num_shards > 1:
        new_ext, new_pts, _ = NBA.ba_solve_distributed(*args, num_shards=ba_num_shards,
                                                       huber_delta=4.0)
    else:
        new_ext, new_pts, _ = NBA.ba_solve(*args, huber_delta=4.0)
    for i, iid in enumerate(iids):
        rec.images[iid].qvec_wxyz = CIO._mat_to_qvec_wxyz(new_ext[i, :3, :3])
        rec.images[iid].tvec = new_ext[i, :3, 3].astype(np.float64)
    for i, pid in enumerate(pids):
        rec.points3d[pid].xyz = new_pts[i].astype(np.float64)
    timings["ba_native"] = timings.get("ba_native", 0.0) + time.perf_counter() - t0
    return rec
