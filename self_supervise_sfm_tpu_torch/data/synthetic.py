"""Synthetic IMC2021-format scene generator for tests and benchmarks.

Port of ``self_supervise_sfm_tpu/data/synthetic.py``: geometrically
consistent fixture scenes written in the HDF5 layout the loader reads.
Cameras observe textured planes, so ground-truth poses, intrinsics, depth
and dense correspondences agree exactly (reprojection residual ~ 0). The
writer needs ``h5py`` and PIL, imported where it writes.
"""

from __future__ import annotations

import io as _io
import os
from typing import Tuple

import numpy as np


def _look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """World-to-camera [R|t] (OpenCV convention: z forward, y down)."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    R = np.stack([x, y, z], axis=0)  # rows: cam axes in world coords
    t = -R @ eye
    return np.concatenate([R, t[:, None]], axis=1).astype(np.float32)


def _plane_intersect(origins, dirs, n, d):
    """Ray/plane intersection: points where (p . n) + d = 0."""
    denom = dirs @ n
    tval = -(origins @ n + d) / denom
    return origins + dirs * tval[..., None]


def _raycast(origin, dirs, planes):
    """Nearest positive-t hit over a plane list -> (points, t).

    ``origin``: (3,); ``dirs``: (..., 3); ``planes``: [(n (3,), d)].
    Rays that miss every plane (never happens for the shipped geometries —
    the back wall spans the frustum) fall back to the last plane.
    """
    best_t = None
    for n, d in planes:
        denom = dirs @ n
        t = -(origin @ n + d) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        t = np.where((denom != 0) & (t > 1e-6), t, np.inf)
        best_t = t if best_t is None else np.minimum(best_t, t)
    best_t = np.where(np.isfinite(best_t), best_t, 1e3)
    return origin + dirs * best_t[..., None], best_t


_GEOMETRIES = {
    # the original slanted plane: every 3D point is coplanar. Exact and
    # simple, but plane-induced homographies leave a FAMILY of (K, R, t)
    # that reproject a plane pixel-exactly — pose is not identifiable from
    # reprojection alone (measured: CDF fine-tuning reaches sub-pixel
    # residuals while relative rotations stay ~10 deg off). Keep for
    # loss/loader tests; do NOT use for pose-accuracy experiments.
    "plane": [
        (np.array([0.05, -0.08, 1.0]) / np.linalg.norm([0.05, -0.08, 1.0]),
         -5.0),
    ],
    # open room corner: back wall + left wall + floor, mutually orthogonal.
    # Non-coplanar structure breaks the homography ambiguity — with exact
    # correspondences + depths the reprojection objective identifies
    # (K, R, t) up to the global similarity gauge.
    "corner": [
        (np.array([0.0, 0.0, 1.0]), -5.0),   # back wall  z = 5
        (np.array([1.0, 0.0, 0.0]), 2.0),    # left wall  x = -2
        (np.array([0.0, 1.0, 0.0]), -1.5),   # floor      y = 1.5 (y down)
    ],
}


def _randomized_corner(rng: np.random.Generator):
    """Per-seed corner variant: wall positions/slants drawn from the rng.

    The fixed "corner" planes make every seed the same room — a pretrained
    prior then already sits at the objective's optimum on an "unseen" seed
    and test-time adaptation has nothing to close (measured: before-ATE
    0.036, fine-tuning only adds SGD noise). Randomizing the geometry (and
    texture, see ``_texture`` params) gives held-out seeds genuine novelty.
    """
    def unit(v):
        return v / np.linalg.norm(v)

    back_z = 5.0 + rng.uniform(-1.0, 1.0)
    left_x = -2.0 + rng.uniform(-0.7, 0.7)
    floor_y = 1.5 + rng.uniform(-0.5, 0.5)
    return [
        (unit(np.array([rng.uniform(-0.15, 0.15),
                        rng.uniform(-0.15, 0.15), 1.0])), -back_z),
        (unit(np.array([1.0, rng.uniform(-0.15, 0.15),
                        rng.uniform(-0.15, 0.15)])), -left_x),
        (unit(np.array([rng.uniform(-0.15, 0.15), 1.0,
                        rng.uniform(-0.15, 0.15)])), -floor_y),
    ]


def _texture(world_xy: np.ndarray, params: np.ndarray | None = None) -> np.ndarray:
    """Smooth deterministic RGB texture from world plane coordinates.

    ``params``: optional (3, 3) [freq_u, freq_v, phase] per channel — used by
    the randomized corner scenes so different seeds carry genuinely
    different appearance (None keeps the original fixed texture, which every
    "plane" fixture test depends on).
    """
    u, v = world_xy[..., 0], world_xy[..., 1]
    if params is None:
        r = 0.5 + 0.5 * np.sin(2.1 * u) * np.cos(1.3 * v)
        g = 0.5 + 0.5 * np.sin(1.7 * u + 0.5) * np.sin(2.3 * v)
        b = 0.5 + 0.5 * np.cos(1.1 * u) * np.cos(0.7 * v + 1.0)
    else:
        (fr, gr, pr), (fg, gg, pg), (fb, gb, pb) = params
        r = 0.5 + 0.5 * np.sin(fr * u + pr) * np.cos(gr * v)
        g = 0.5 + 0.5 * np.sin(fg * u + pg) * np.sin(gg * v)
        b = 0.5 + 0.5 * np.cos(fb * u + pb) * np.cos(gb * v)
    return np.clip(np.stack([r, g, b], -1) * 255, 0, 255).astype(np.uint8)


def make_synthetic_scene(
    scene_dir: str,
    num_images: int = 4,
    image_size: Tuple[int, int] = (64, 48),  # (w, h)
    focal: float = 70.0,
    seed: int = 0,
    geometry: str = "plane",
) -> str:
    """Write ``<scene_dir>/scene.hdf5`` in the reference layout; returns path.

    ``geometry``: "plane" (default, the original slanted-plane fixture),
    "corner" (non-coplanar 3-wall room — required for pose-identifiability;
    see ``_GEOMETRIES``) or "corner_rand" (corner with per-seed wall
    positions/slants AND per-seed texture — distribution shift across
    seeds, required for test-time-adaptation experiments; see
    ``_randomized_corner``). Correspondences are occlusion-checked by a
    visibility ray-cast from the destination camera.
    """
    import h5py
    from PIL import Image

    rng = np.random.default_rng(seed)
    w, h = image_size
    os.makedirs(scene_dir, exist_ok=True)

    tex_params = None
    if geometry == "corner_rand":
        planes = _randomized_corner(rng)
        tex_params = np.stack([
            rng.uniform([1.0, 0.7, 0.0], [3.0, 2.8, 6.28], size=3)
            for _ in range(3)
        ])
    else:
        planes = _GEOMETRIES[geometry]
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)

    extrinsics, centers = [], []
    for i in range(num_images):
        ang = 2 * np.pi * i / max(num_images, 1)
        if geometry in ("corner", "corner_rand"):
            # modest-baseline ring near the origin, aimed so back wall,
            # left wall and floor all enter the frustum
            eye = np.array(
                [0.6 * np.cos(ang), 0.4 * np.sin(ang),
                 0.3 * rng.uniform(-1, 1)]
            )
            target = np.array(
                [-0.6 + 0.3 * np.sin(ang), 0.5 + 0.2 * np.cos(ang), 5.0]
            )
        else:
            eye = np.array(
                [1.2 * np.cos(ang), 1.0 * np.sin(ang),
                 0.3 * rng.uniform(-1, 1)]
            )
            target = np.array([0.4 * np.sin(ang), 0.3 * np.cos(ang), 5.0])
        E = _look_at(eye, target, np.array([0.0, -1.0, 0.0]))
        extrinsics.append(E)
        centers.append(eye)

    def cam_rays(E, px, py):
        """World-space origins + directions through pixels (px, py)."""
        R, t = E[:, :3], E[:, 3]
        cam_dirs = np.stack(
            [(px - K[0, 2]) / K[0, 0], (py - K[1, 2]) / K[1, 1], np.ones_like(px)],
            axis=-1,
        )
        world_dirs = cam_dirs @ R  # R^T @ d for each
        origin = -R.T @ t
        return origin, world_dirs

    def shade(pts):
        if geometry == "plane":
            return _texture(pts[..., :2])
        # mix all three coordinates so every wall carries texture gradient
        uv = np.stack(
            [pts[..., 0] + 0.6 * pts[..., 1] - 0.4 * pts[..., 2],
             pts[..., 2] - 0.8 * pts[..., 1] + 0.3 * pts[..., 0]],
            axis=-1,
        )
        return _texture(uv, tex_params)

    def visible(pts, eye):
        """True where ``pts`` are unoccluded from camera centre ``eye``."""
        rel = pts - eye
        dist = np.linalg.norm(rel, axis=-1)
        dirs = rel / np.maximum(dist[..., None], 1e-12)
        _, t_hit = _raycast(eye, dirs, planes)
        return t_hit >= dist * (1.0 - 1e-3)

    def render(E):
        uu, vv = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
        origin, dirs = cam_rays(E, uu, vv)
        pts, _ = _raycast(origin, dirs, planes)
        depth = (pts - origin) @ E[:, :3][2]  # z in camera frame
        rgb = shade(pts)
        return rgb, depth.astype(np.float32), pts

    def project(E, pts):
        cam = pts @ E[:, :3].T + E[:, 3]
        px = cam @ K.T
        return px[..., :2] / px[..., 2:3], cam[..., 2]

    def png_bytes(img, fmt: str) -> np.ndarray:
        buf = _io.BytesIO()
        img.save(buf, format=fmt)
        return np.frombuffer(buf.getvalue(), dtype=np.uint8)

    h5path = os.path.join(scene_dir, "scene.hdf5")
    with h5py.File(h5path, "w") as f:
        g_rgb = f.create_group("rgb")
        g_dep = f.create_group("depth_pr")
        g_cor = f.create_group("corres_i2j")
        g_k = f.create_group("intrinsic_gt")
        g_pose = f.create_group("pose_w2c_gt")

        renders = []
        for i, E in enumerate(extrinsics):
            rgb, depth, pts = render(E)
            renders.append((rgb, depth, pts))
            name = f"{i:06d}"
            g_rgb.create_dataset(
                f"{name}.jpg", data=png_bytes(Image.fromarray(rgb), "JPEG")
            )
            dep_u16 = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
            g_dep.create_dataset(
                f"{name}.png", data=png_bytes(Image.fromarray(dep_u16), "PNG")
            )
            g_k.create_dataset(f"{name}.txt", data=K)
            E44 = np.eye(4, dtype=np.float32)
            E44[:3] = E
            g_pose.create_dataset(f"{name}.txt", data=E44)

        # dense correspondences i->j: src grid uses the loader's normalised
        # convention (imc2021.py:124-133 + io.py torchncoords2coordinates)
        xs = np.linspace(-1 + 1 / w, 1 - 1 / w, w)
        ys = np.linspace(-1 + 1 / h, 1 - 1 / h, h)
        xn, yn = np.meshgrid(xs, ys, indexing="xy")
        src_px = (xn + 1) * (w - 1) / 2
        src_py = (yn + 1) * (h - 1) / 2
        for i, Ei in enumerate(extrinsics):
            origin, dirs = cam_rays(Ei, src_px, src_py)
            pts, _ = _raycast(origin, dirs, planes)
            for j, Ej in enumerate(extrinsics):
                if i == j:
                    continue
                dst_px, dst_z = project(Ej, pts)
                xn_d = 2 * dst_px[..., 0] / (w - 1) - 1
                yn_d = 2 * dst_px[..., 1] / (h - 1) - 1
                inb = (
                    (np.abs(xn_d) < 1) & (np.abs(yn_d) < 1) & (dst_z > 0)
                    & visible(pts, centers[j])
                )
                enc = lambda a: np.clip(
                    (np.clip(a, -1, 1) + 1) / 2 * 65535, 0, 65535
                ).astype(np.uint16)
                conf = np.where(inb, 1000, 0).astype(np.uint16)
                pair = f"{i:06d}_{j:06d}"
                gp = g_cor.create_group(pair)
                gp.create_dataset(
                    f"{pair}_x.png", data=png_bytes(Image.fromarray(enc(xn_d)), "PNG")
                )
                gp.create_dataset(
                    f"{pair}_y.png", data=png_bytes(Image.fromarray(enc(yn_d)), "PNG")
                )
                gp.create_dataset(
                    f"{pair}_conf.png", data=png_bytes(Image.fromarray(conf), "PNG")
                )
    return h5path


def make_synthetic_dataset(root: str, num_scenes: int = 2, **kw) -> str:
    for s in range(num_scenes):
        make_synthetic_scene(os.path.join(root, f"scene_{s:03d}"), seed=s, **kw)
    return root
