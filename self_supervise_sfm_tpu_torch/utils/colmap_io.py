"""Reconstruction container, COLMAP model I/O and the bundle-adjustment
hand-off.

Port of ``self_supervise_sfm_tpu/utils/colmap_io.py``:

- :class:`Reconstruction` holds cameras, images and 3D points with tracks;
- :func:`batch_matrix_to_reconstruction` builds one from predicted tracks,
  poses and points, with reprojection-error masking and per-frame inlier
  gating; :func:`reconstruction_to_batch_matrix` goes back;
- :meth:`Reconstruction.write_text` / :meth:`read_text` and
  :meth:`write_binary` / :meth:`read_binary` write and read the COLMAP
  sparse model (``cameras`` / ``images`` / ``points3D``, ``.txt`` and
  ``.bin``), byte for byte as the JAX package does;
- :func:`refine` runs the port's bundle adjuster (``ops/bundle_adjust.py``)
  on a device, ``cuda`` unless asked for the CPU.

The rotations go through the port's geometry on fp32 CPU tensors, as the JAX
package's go through ``jnp`` in fp32.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import geometry as G

# COLMAP camera-model ids (src/colmap/sensor/models.h); only the pinhole
# family is producible from predicted intrinsics, matching the reference's
# SIMPLE_PINHOLE/PINHOLE choice (np_to_pycolmap.py:314-355)
_CAMERA_MODEL_IDS = {"SIMPLE_PINHOLE": 0, "PINHOLE": 1}
_CAMERA_MODEL_NAMES = {v: k for k, v in _CAMERA_MODEL_IDS.items()}
_CAMERA_NUM_PARAMS = {"SIMPLE_PINHOLE": 3, "PINHOLE": 4}


@dataclass
class Camera:
    camera_id: int
    model: str  # "PINHOLE" | "SIMPLE_PINHOLE"
    width: int
    height: int
    params: np.ndarray  # PINHOLE: [fx, fy, cx, cy]; SIMPLE: [f, cx, cy]

    @property
    def K(self) -> np.ndarray:
        if self.model == "SIMPLE_PINHOLE":
            f, cx, cy = self.params
            return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)
        fx, fy, cx, cy = self.params
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class ImageRecord:
    image_id: int
    name: str
    camera_id: int
    qvec_wxyz: np.ndarray  # COLMAP stores scalar-FIRST quaternions
    tvec: np.ndarray
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3d_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    @property
    def w2c(self) -> np.ndarray:
        q = self.qvec_wxyz
        xyzw = np.array([q[1], q[2], q[3], q[0]], np.float32)
        R = G.quat_to_mat(torch.from_numpy(xyzw)).numpy()
        return np.concatenate([R, self.tvec[:, None]], axis=1)


@dataclass
class Point3D:
    point3d_id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    track: List[Tuple[int, int]]  # (image_id, point2d_idx)


@dataclass
class Reconstruction:
    cameras: Dict[int, Camera] = field(default_factory=dict)
    images: Dict[int, ImageRecord] = field(default_factory=dict)
    points3d: Dict[int, Point3D] = field(default_factory=dict)

    # -- COLMAP text model IO ------------------------------------------------

    def write_text(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cameras.txt"), "w") as f:
            f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            for cam in self.cameras.values():
                params = " ".join(f"{p:.10g}" for p in cam.params)
                f.write(f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n")
        with open(os.path.join(out_dir, "images.txt"), "w") as f:
            f.write(
                "# Image list: IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID,"
                " NAME\n#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
            )
            for im in self.images.values():
                q = im.qvec_wxyz
                t = im.tvec
                f.write(
                    f"{im.image_id} {q[0]:.10g} {q[1]:.10g} {q[2]:.10g} {q[3]:.10g} "
                    f"{t[0]:.10g} {t[1]:.10g} {t[2]:.10g} {im.camera_id} {im.name}\n"
                )
                obs = " ".join(
                    f"{xy[0]:.4f} {xy[1]:.4f} {pid}"
                    for xy, pid in zip(im.xys, im.point3d_ids)
                )
                f.write(obs + "\n")
        with open(os.path.join(out_dir, "points3D.txt"), "w") as f:
            f.write(
                "# 3D point list: POINT3D_ID, X, Y, Z, R, G, B, ERROR,"
                " TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            )
            for pt in self.points3d.values():
                xyz = " ".join(f"{v:.10g}" for v in pt.xyz)
                rgb = " ".join(str(int(v)) for v in pt.rgb)
                track = " ".join(f"{i} {j}" for i, j in pt.track)
                f.write(f"{pt.point3d_id} {xyz} {rgb} {pt.error:.6g} {track}\n")
        return out_dir

    @staticmethod
    def read_text(model_dir: str) -> "Reconstruction":
        rec = Reconstruction()
        with open(os.path.join(model_dir, "cameras.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                rec.cameras[int(parts[0])] = Camera(
                    int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
                    np.asarray([float(p) for p in parts[4:]]),
                )
        with open(os.path.join(model_dir, "images.txt")) as f:
            lines = [l for l in f if not l.startswith("#")]
        for head, obs in zip(lines[0::2], lines[1::2]):
            parts = head.split()
            im = ImageRecord(
                int(parts[0]), parts[9], int(parts[8]),
                np.asarray([float(p) for p in parts[1:5]]),
                np.asarray([float(p) for p in parts[5:8]]),
            )
            vals = obs.split()
            if vals:
                arr = np.asarray(vals, dtype=np.float64).reshape(-1, 3)
                im.xys = arr[:, :2]
                im.point3d_ids = arr[:, 2].astype(np.int64)
            rec.images[im.image_id] = im
        with open(os.path.join(model_dir, "points3D.txt")) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                parts = line.split()
                track = [
                    (int(parts[i]), int(parts[i + 1]))
                    for i in range(8, len(parts), 2)
                ]
                rec.points3d[int(parts[0])] = Point3D(
                    int(parts[0]),
                    np.asarray([float(p) for p in parts[1:4]]),
                    np.asarray([int(p) for p in parts[4:7]]),
                    float(parts[7]),
                    track,
                )
        return rec


    # -- COLMAP binary model IO ----------------------------------------------
    # Little-endian layout per colmap/scripts/python/read_write_model.py.

    def write_binary(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "cameras.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(self.cameras)))
            for cam in self.cameras.values():
                f.write(struct.pack(
                    "<iiQQ", cam.camera_id, _CAMERA_MODEL_IDS[cam.model],
                    cam.width, cam.height,
                ))
                f.write(np.asarray(cam.params, "<f8").tobytes())
        with open(os.path.join(out_dir, "images.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(self.images)))
            for im in self.images.values():
                f.write(struct.pack("<i", im.image_id))
                f.write(np.asarray(im.qvec_wxyz, "<f8").tobytes())
                f.write(np.asarray(im.tvec, "<f8").tobytes())
                f.write(struct.pack("<i", im.camera_id))
                f.write(im.name.encode() + b"\x00")
                f.write(struct.pack("<Q", len(im.xys)))
                obs = np.empty((len(im.xys), 3), "<f8")
                obs[:, :2] = im.xys
                # COLMAP stores POINT3D_ID as int64; -1 marks no 3D point
                obs[:, 2:].view("<i8")[:, 0] = im.point3d_ids
                f.write(obs.tobytes())
        with open(os.path.join(out_dir, "points3D.bin"), "wb") as f:
            f.write(struct.pack("<Q", len(self.points3d)))
            for pt in self.points3d.values():
                f.write(struct.pack("<q", pt.point3d_id))
                f.write(np.asarray(pt.xyz, "<f8").tobytes())
                f.write(struct.pack("<BBB", *(int(v) for v in pt.rgb)))
                f.write(struct.pack("<d", pt.error))
                f.write(struct.pack("<Q", len(pt.track)))
                for iid, idx in pt.track:
                    f.write(struct.pack("<ii", iid, idx))
        return out_dir

    @staticmethod
    def read_binary(model_dir: str) -> "Reconstruction":
        rec = Reconstruction()
        with open(os.path.join(model_dir, "cameras.bin"), "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                cid, mid, w, h = struct.unpack("<iiQQ", f.read(24))
                model = _CAMERA_MODEL_NAMES[mid]
                np_params = _CAMERA_NUM_PARAMS[model]
                params = np.frombuffer(f.read(8 * np_params), "<f8").copy()
                rec.cameras[cid] = Camera(cid, model, int(w), int(h), params)
        with open(os.path.join(model_dir, "images.bin"), "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                (iid,) = struct.unpack("<i", f.read(4))
                qt = np.frombuffer(f.read(56), "<f8")
                (cam_id,) = struct.unpack("<i", f.read(4))
                name = b""
                while (c := f.read(1)) != b"\x00":
                    if not c:
                        raise ValueError(
                            "truncated images.bin: EOF inside image name"
                        )
                    name += c
                (num_pts,) = struct.unpack("<Q", f.read(8))
                obs = np.frombuffer(f.read(24 * num_pts), "<f8").reshape(-1, 3)
                im = ImageRecord(
                    iid, name.decode(), cam_id, qt[:4].copy(), qt[4:].copy()
                )
                im.xys = obs[:, :2].copy()
                im.point3d_ids = obs[:, 2:].view("<i8")[:, 0].copy()
                rec.images[iid] = im
        with open(os.path.join(model_dir, "points3D.bin"), "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            for _ in range(n):
                (pid,) = struct.unpack("<q", f.read(8))
                xyz = np.frombuffer(f.read(24), "<f8").copy()
                rgb = np.asarray(struct.unpack("<BBB", f.read(3)))
                (err,) = struct.unpack("<d", f.read(8))
                (tl,) = struct.unpack("<Q", f.read(8))
                raw = struct.unpack(f"<{2 * tl}i", f.read(8 * tl))
                track = [(raw[2 * i], raw[2 * i + 1]) for i in range(tl)]
                rec.points3d[pid] = Point3D(pid, xyz, rgb, err, track)
        return rec


def _mat_to_qvec_wxyz(R: np.ndarray) -> np.ndarray:
    xyzw = G.mat_to_quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()
    return np.array([xyzw[3], xyzw[0], xyzw[1], xyzw[2]])


def batch_matrix_to_reconstruction(
    points3d: np.ndarray,  # (P, 3)
    points_xyf: np.ndarray,  # unused placeholder kept for parity of signature
    tracks: np.ndarray,  # (S, P, 2) per-frame 2D track positions
    masks: np.ndarray,  # (S, P) visibility/validity
    extrinsics: np.ndarray,  # (S, 3, 4)
    intrinsics: np.ndarray,  # (S, 3, 3)
    image_size: Tuple[int, int],  # (W, H)
    max_reproj_error: Optional[float] = None,
    min_inlier_per_frame: int = 64,
    min_valid_track_length: int = 2,
    shared_camera: bool = False,
    camera_type: str = "PINHOLE",
    colors: Optional[np.ndarray] = None,
) -> Tuple[Optional[Reconstruction], np.ndarray]:
    """Predicted tracks/poses/points -> Reconstruction (+ final valid mask).

    Mirrors ``batch_np_matrix_to_pycolmap`` (``np_to_pycolmap.py:13-157``):
    reprojection-error masking, per-frame inlier gating, min track length.
    """
    S, P = masks.shape
    masks = masks.astype(bool).copy()

    if max_reproj_error is not None:
        proj, cam_pts = G.project_world_points_to_cam(
            torch.from_numpy(np.asarray(points3d, np.float32)),
            torch.from_numpy(np.asarray(extrinsics, np.float32)),
            torch.from_numpy(np.asarray(intrinsics, np.float32)),
        )
        err = np.linalg.norm(proj.numpy() - tracks, axis=-1)
        masks &= err < max_reproj_error
        masks &= cam_pts.numpy()[:, 2, :] > 0  # in front of camera

    inliers_per_frame = masks.sum(axis=1)
    if (inliers_per_frame < min_inlier_per_frame).any():
        bad = int((inliers_per_frame < min_inlier_per_frame).sum())
        print(f"[colmap_io] {bad} frames below min inliers — keeping anyway")

    track_len = masks.sum(axis=0)
    valid_points = track_len >= min_valid_track_length
    masks &= valid_points[None, :]

    rec = Reconstruction()
    W, H = image_size
    for s in range(S):
        if shared_camera and s > 0:
            cam_id = 1
        else:
            cam_id = s + 1
            K = intrinsics[s]
            if camera_type == "SIMPLE_PINHOLE":
                params = np.asarray([(K[0, 0] + K[1, 1]) / 2, K[0, 2], K[1, 2]])
            else:
                params = np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])
            rec.cameras[cam_id] = Camera(cam_id, camera_type, W, H, params)
        R = extrinsics[s, :3, :3]
        t = extrinsics[s, :3, 3]
        rec.images[s + 1] = ImageRecord(
            s + 1, f"image_{s:06d}.jpg", cam_id, _mat_to_qvec_wxyz(R), t.astype(np.float64)
        )

    # image s observes the valid points with masks[s, p] in increasing p (the
    # JAX package's order of appends), point p at its rank among them
    rank = np.cumsum(masks, axis=1) - 1
    for s in range(S):
        pts_s = np.flatnonzero(masks[s])
        rec.images[s + 1].xys = tracks[s, pts_s].astype(np.float64).reshape(-1, 2)
        rec.images[s + 1].point3d_ids = (pts_s + 1).astype(np.int64)
    for p in np.flatnonzero(valid_points):
        track = [(int(s) + 1, int(rank[s, p])) for s in np.flatnonzero(masks[:, p])]
        rgb = colors[p] if colors is not None else np.array([128, 128, 128])
        rec.points3d[int(p) + 1] = Point3D(
            int(p) + 1, points3d[p].astype(np.float64), rgb, 0.0, track
        )
    if not rec.points3d:
        return None, valid_points
    return rec, valid_points


def reconstruction_to_batch_matrix(rec: Reconstruction):
    """Reconstruction -> (points3d, extrinsics, intrinsics) arrays.

    Mirrors ``pycolmap_to_batch_np_matrix`` (``np_to_pycolmap.py:160-209``).
    """
    pids = sorted(rec.points3d.keys())
    points = np.stack([rec.points3d[i].xyz for i in pids])
    iids = sorted(rec.images.keys())
    extrinsics = np.stack([rec.images[i].w2c for i in iids])
    intrinsics = np.stack([rec.cameras[rec.images[i].camera_id].K for i in iids])
    return points, extrinsics, intrinsics


def observations(rec: Reconstruction):
    """The observation lists of a reconstruction, for a bundle adjuster:
    (point ids, image ids, both sorted; per observation the image's and the
    point's index in those lists and its (2,) pixel), in the points' and
    their tracks' order."""
    pids = sorted(rec.points3d.keys())
    iids = sorted(rec.images.keys())
    iid_to_idx = {p: i for i, p in enumerate(iids)}
    cam_idx, pt_idx, uv = [], [], []
    for i, pid in enumerate(pids):
        for iid, obs_idx in rec.points3d[pid].track:
            cam_idx.append(iid_to_idx[iid])
            pt_idx.append(i)
            uv.append(rec.images[iid].xys[obs_idx])
    return pids, iids, np.asarray(cam_idx), np.asarray(pt_idx), np.asarray(uv, np.float64)


def refine(rec: Reconstruction, cfg=None, gauge_fix: bool = True,
           device="cuda") -> Reconstruction:
    """Bundle-adjust a reconstruction in place with ``ops/bundle_adjust`` on
    ``device`` (``cuda`` unless asked for ``cpu``; without a card ``cuda``
    raises).

    ``gauge_fix`` (default on, as COLMAP's BA) freezes camera 0 and one
    translation component of camera 1, so that the refinement keeps the
    global frame and scale of the feed-forward reconstruction.
    """
    from ..models.sailrecon import _device
    from ..ops import bundle_adjust as BA

    dev = _device(device)
    pids, iids, cam_idx, pt_idx, uv = observations(rec)
    points, extrinsics, intrinsics = reconstruction_to_batch_matrix(rec)

    def on_dev(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    prob = BA.make_problem(
        on_dev(extrinsics), on_dev(intrinsics), on_dev(points),
        on_dev(cam_idx, np.int64), on_dev(pt_idx, np.int64), on_dev(uv),
    )
    cfg = cfg or BA.BAConfig()
    mask = BA.gauge_mask(prob, cfg) if gauge_fix and len(iids) > 1 else None
    refined, info = BA.bundle_adjust(prob, cfg, free_mask=mask, device=dev)
    new_ext = BA.extrinsics_from_params(refined.cam_params).cpu().numpy()
    new_pts = refined.points.cpu().numpy()
    for i, iid in enumerate(iids):
        rec.images[iid].qvec_wxyz = _mat_to_qvec_wxyz(new_ext[i, :3, :3])
        rec.images[iid].tvec = new_ext[i, :3, 3].astype(np.float64)
    for i, pid in enumerate(pids):
        rec.points3d[pid].xyz = new_pts[i].astype(np.float64)
    return rec
