"""Reconstruction export: PLY point clouds, KITTI-format poses, samplers.

Port of ``self_supervise_sfm_tpu/utils/export.py`` (numpy only):

- ``save_pointcloud_ply``  per-view point maps (+ RGB) as one binary PLY
- ``save_kitti_poses``     camera-to-world poses, one 3x4 row-major line each
- ``uniform_sample``       order-keeping uniform subsample
- ``to_cpu``               a tree of tensors / arrays as numpy

The PLY writer is self-contained binary little-endian (no plyfile).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np


def to_cpu(tree):
    """Recursively materialise tensors (on any device) and arrays as numpy."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "__array__"):
        return np.asarray(tree)
    return tree


def uniform_sample(items: Sequence, num: int) -> List:
    """Uniformly subsample ``num`` items (keeps order, endpoints included)."""
    n = len(items)
    if num >= n:
        return list(items)
    idx = np.linspace(0, n - 1, num).round().astype(int)
    return [items[i] for i in idx]


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
):
    """Binary little-endian PLY of (N, 3) float points (+ optional uint8 RGB)."""
    points = np.asarray(points, np.float32).reshape(-1, 3)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors).reshape(-1, 3)
        if colors.dtype != np.uint8:
            in_unit_range = colors.size == 0 or colors.max() <= 1.0 + 1e-6
            colors = np.clip(
                colors * 255.0 if in_unit_range else colors, 0, 255
            ).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {c}" for c in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
            rec["xyz"] = points
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(points.astype("<f4").tobytes())


def read_ply(path: str):
    """Minimal reader for the PLYs produced by :func:`write_ply`."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        n = int(next(l for l in header if l.startswith("element vertex")).split()[-1])
        has_color = any("uchar" in l for l in header)
        if has_color:
            rec = np.frombuffer(
                f.read(n * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)]
            )
            return rec["xyz"].copy(), rec["rgb"].copy()
        pts = np.frombuffer(f.read(n * 12), dtype="<f4").reshape(n, 3)
        return pts.copy(), None


def save_pointcloud_ply(
    predictions: List[Dict[str, np.ndarray]],
    path: str,
    conf_key: str = "xyz_cnf",
    point_key: str = "point_map",
    conf_threshold: float = 1.5,
    max_points: int = 1_000_000,
):
    """Dump predicted per-view point maps (+ RGB) as one PLY.

    ``predictions``: per-view dicts as returned by the facade (leading batch
    dim 1 or absent). Points below the confidence threshold are dropped
    (mirrors the demo-path confidence filtering).
    """
    pts_all, col_all = [], []
    for pred in predictions:
        pts = np.asarray(pred[point_key]).reshape(-1, 3)
        keep = np.ones(pts.shape[0], bool)
        if conf_key in pred:
            conf = np.asarray(pred[conf_key]).reshape(-1)
            keep &= conf > conf_threshold
            if not keep.any():  # e.g. untrained model — keep everything
                keep = np.ones(pts.shape[0], bool)
        rgb = None
        for k in ("rgbs", "images"):
            if k in pred:
                rgb = np.asarray(pred[k])
                break
        pts_all.append(pts[keep])
        if rgb is not None:
            rgb = rgb.reshape(-1, 3) if rgb.shape[-1] == 3 else (
                np.moveaxis(rgb.reshape(3, -1), 0, 1)
            )
            col_all.append(rgb[keep])
    points = np.concatenate(pts_all, axis=0)
    colors = np.concatenate(col_all, axis=0) if col_all else None
    if points.shape[0] > max_points:
        idx = np.random.default_rng(0).choice(
            points.shape[0], max_points, replace=False
        )
        points = points[idx]
        colors = colors[idx] if colors is not None else None
    write_ply(path, points, colors)
    return path


def save_kitti_poses(extrinsics_w2c: np.ndarray, path: str):
    """Write camera-to-world poses, one 3x4 row-major line each (KITTI)."""
    E = np.asarray(extrinsics_w2c)
    if E.shape[-2:] == (3, 4):
        bottom = np.broadcast_to(
            np.array([0, 0, 0, 1.0], E.dtype), E.shape[:-2] + (1, 4)
        )
        E = np.concatenate([E, bottom], axis=-2)
    c2w = np.linalg.inv(E)
    with open(path, "w") as f:
        for pose in c2w.reshape(-1, 4, 4):
            f.write(" ".join(f"{v:.9g}" for v in pose[:3].reshape(-1)) + "\n")
    return path


def load_kitti_poses(path: str) -> np.ndarray:
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows
