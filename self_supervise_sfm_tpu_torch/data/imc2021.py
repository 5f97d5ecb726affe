"""IMC2021 phototourism scene dataset (HDF5): the self-supervised feed.

Port of ``self_supervise_sfm_tpu/data/imc2021.py``. Each scene folder holds
one HDF5 file with groups:

- ``rgb/<name>.jpg``           JPEG bytes
- ``depth_pr/<name>.png``      uint16-mm PNG (monocular depth prior)
- ``corres_i2j/<i>_<j>/``      dense warps as uint16 PNG triplets ``_x/_y``
  (normalised coords, u16/65535*2-1) and ``_conf`` (u16/1000)
- ``intrinsic_gt/<name>.txt``  3x3 K (never used in the loss)
- ``pose_w2c_gt/<name>.txt``   4x4 world-to-cam (evaluation only)

The loader emits fixed-shape numpy dicts: correspondences are sampled to
``sample_num`` points and pairs padded to ``max_pairs`` with a validity
mask, so every scene has the same shapes. ``h5py`` and PIL are imported
where a scene is read.
"""

from __future__ import annotations

import glob
import io as _io
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np

from .preprocess import preprocess_image, sample_correspondence_and_depth


def _natsort_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


class IMC2021Scenes:
    """Scene-per-item reader over IMC2021-format HDF5 folders."""

    def __init__(
        self,
        root: str,
        sample_num: int = 10000,
        min_corres_conf: float = 0.1,
        num_images: int = 5,
        target_size: int = 518,
        max_pairs: Optional[int] = None,
        shared_focal: bool = False,
        use_native: Optional[bool] = False,
        decode_threads: int = 4,
    ):
        """``use_native``: route decode/preprocess/sampling through the C++
        data plane (``native/dataplane.py``) with ``decode_threads`` GIL-free
        worker threads. None = auto (native when the library builds).
        The native sampler draws from the same certainty-weighted
        distribution via its own RNG stream, so per-draw indices differ from
        the numpy path (decode + preprocessing are golden-identical)."""
        self.root = root
        self.sample_num = sample_num
        self.min_corres_conf = min_corres_conf
        self.num_images = num_images
        self.target_size = target_size
        # every ordered pair can appear (i, j) and (j, i)
        self.max_pairs = max_pairs or num_images * (num_images - 1)
        self.shared_focal = shared_focal
        if use_native is None:
            from ..native import dataplane as _dp

            use_native = _dp.available()
        self.use_native = bool(use_native)
        self.decode_threads = decode_threads
        self.scene_folders = sorted(
            d
            for d in glob.glob(os.path.join(root, "*"))
            if os.path.isdir(d) and glob.glob(os.path.join(d, "*.hdf5"))
        )
        if not self.scene_folders:
            raise FileNotFoundError(f"No HDF5 scene folders under {root}")

    def __len__(self) -> int:
        return len(self.scene_folders)

    @staticmethod
    def _decode_image(h5node):
        from PIL import Image

        return Image.open(_io.BytesIO(np.array(h5node)))

    @staticmethod
    def _png2coords(arr: np.ndarray) -> np.ndarray:
        return arr.astype(np.float32) / 65535.0 * 2.0 - 1.0

    @staticmethod
    def _png2certainty(arr: np.ndarray) -> np.ndarray:
        return arr.astype(np.float32) / 1000.0

    def _read_corres(self, f, pair_name: str):
        g = f["corres_i2j"][pair_name]
        cx = self._png2coords(np.array(self._decode_image(g[f"{pair_name}_x.png"])))
        cy = self._png2coords(np.array(self._decode_image(g[f"{pair_name}_y.png"])))
        certainty = self._png2certainty(
            np.array(self._decode_image(g[f"{pair_name}_conf.png"]))
        )
        hs, ws = certainty.shape
        coords_dst = np.stack([cx, cy], axis=-1)
        xx, yy = np.meshgrid(
            np.linspace(-1 + 1 / ws, 1 - 1 / ws, ws),
            np.linspace(-1 + 1 / hs, 1 - 1 / hs, hs),
            indexing="xy",
        )
        coords_src = np.stack([xx, yy], axis=-1).astype(np.float32)
        return coords_src, coords_dst, certainty

    def load_scene(
        self, idx: int, rng: Optional[np.random.Generator] = None
    ) -> Dict[str, Any]:
        """Returns one scene as fixed-shape numpy arrays.

        Keys: scene_name, images (N, T, T, 3), depth_processed (N, T, T),
        K_to_K_prime / K_prime_to_K / K_gt (N, 3, 3), poses_w2c_gt (N, 4, 4),
        src_idx / dst_idx (max_pairs,), src_coords / dst_coords
        (max_pairs, K, 2), src_depth / dst_depth (max_pairs, K),
        pair_valid (max_pairs,), shared_focal.
        """
        import h5py

        rng = rng or np.random.default_rng()
        if self.use_native:
            return self._load_scene_native(idx, rng)
        folder = self.scene_folders[idx]
        h5path = glob.glob(os.path.join(folder, "*.hdf5"))[0]
        out: Dict[str, Any] = {"scene_name": os.path.basename(folder)}

        with h5py.File(h5path, "r") as f:
            names = list(f["rgb"].keys())
            if len(names) > self.num_images:
                names = list(rng.choice(names, self.num_images, replace=False))
            names = sorted(names, key=_natsort_key)
            out["image_names"] = names
            n = len(names)

            images, depths, k2kp, kp2k, K_gt, poses = [], [], [], [], [], []
            raw_depths = {}
            for name in names:
                rgb = self._decode_image(f["rgb"][name])
                img, a, b = preprocess_image(rgb, self.target_size, is_depth=False)
                images.append(img)
                k2kp.append(a)
                kp2k.append(b)
                dname = name.replace(".jpg", ".png")
                dep_pil = self._decode_image(f["depth_pr"][dname])
                dep, _, _ = preprocess_image(dep_pil, self.target_size, is_depth=True)
                depths.append(dep)
                raw_depths[name] = np.array(dep_pil).astype(np.float32) / 1000.0
                tname = name.replace(".jpg", ".txt")
                K_gt.append(np.array(f["intrinsic_gt"][tname], np.float32))
                poses.append(np.array(f["pose_w2c_gt"][tname], np.float32))

            out["images"] = np.stack(images)
            out["depth_processed"] = np.stack(depths)
            out["K_to_K_prime"] = np.stack(k2kp)
            out["K_prime_to_K"] = np.stack(kp2k)
            out["K_gt"] = np.stack(K_gt)
            out["poses_w2c_gt"] = np.stack(poses)

            name_to_idx = {nm: i for i, nm in enumerate(names)}
            pairs = []
            for pair_name in f["corres_i2j"].keys():
                # '000000_000001' style keys; take the first two parts
                # instead of a strict 2-way unpack that would raise on extra
                # underscores
                parts = pair_name.split("_")
                if len(parts) < 2:
                    continue
                sa, sb = f"{parts[0]}.jpg", f"{parts[1]}.jpg"
                if sa in name_to_idx and sb in name_to_idx:
                    pairs.append((name_to_idx[sa], name_to_idx[sb], pair_name, sa, sb))
            pairs = pairs[: self.max_pairs]

            K = self.sample_num
            P = self.max_pairs
            src_idx = np.zeros(P, np.int32)
            dst_idx = np.zeros(P, np.int32)
            src_coords = np.zeros((P, K, 2), np.float32)
            dst_coords = np.zeros((P, K, 2), np.float32)
            src_depth = np.zeros((P, K), np.float32)
            dst_depth = np.zeros((P, K), np.float32)
            pair_valid = np.zeros(P, np.float32)

            for i, (si, di, pair_name, sa, sb) in enumerate(pairs):
                cs, cd, cert = self._read_corres(f, pair_name)
                scs, scd, sds, sdd = sample_correspondence_and_depth(
                    cs, cd, cert,
                    raw_depths[sa], raw_depths[sb],
                    sample_num=K, min_corres_conf=self.min_corres_conf, rng=rng,
                )
                src_idx[i], dst_idx[i] = si, di
                src_coords[i], dst_coords[i] = scs, scd
                src_depth[i], dst_depth[i] = sds, sdd
                pair_valid[i] = 1.0

        out["src_idx"] = src_idx
        out["dst_idx"] = dst_idx
        out["src_coords"] = src_coords
        out["dst_coords"] = dst_coords
        out["src_depth"] = src_depth
        out["dst_depth"] = dst_depth
        out["pair_valid"] = pair_valid
        out["shared_focal"] = self.shared_focal
        return out


    def _load_scene_native(self, idx: int, rng: np.random.Generator):
        """Native-data-plane scene load: HDF5 byte reads on this thread (h5py
        is not thread-safe), decode/preprocess/sampling fanned out to GIL-free
        C++ calls on ``decode_threads`` workers."""
        from concurrent.futures import ThreadPoolExecutor

        import h5py

        from ..native import dataplane as dp

        folder = self.scene_folders[idx]
        h5path = glob.glob(os.path.join(folder, "*.hdf5"))[0]
        out: Dict[str, Any] = {"scene_name": os.path.basename(folder)}

        with h5py.File(h5path, "r") as f:
            names = list(f["rgb"].keys())
            if len(names) > self.num_images:
                names = list(rng.choice(names, self.num_images, replace=False))
            names = sorted(names, key=_natsort_key)
            out["image_names"] = names
            n = len(names)

            rgb_bytes, dep_bytes, K_gt, poses = [], [], [], []
            for name in names:
                rgb_bytes.append(np.array(f["rgb"][name]).tobytes())
                dname = name.replace(".jpg", ".png")
                dep_bytes.append(np.array(f["depth_pr"][dname]).tobytes())
                tname = name.replace(".jpg", ".txt")
                K_gt.append(np.array(f["intrinsic_gt"][tname], np.float32))
                poses.append(np.array(f["pose_w2c_gt"][tname], np.float32))

            name_to_idx = {nm: i for i, nm in enumerate(names)}
            pair_jobs = []  # (slot, src_i, dst_i, xbytes, ybytes, cbytes, seed)
            for pair_name in f["corres_i2j"].keys():
                # '000000_000001' style keys; take the first two parts
                # instead of a strict 2-way unpack that would raise on extra
                # underscores
                parts = pair_name.split("_")
                if len(parts) < 2:
                    continue
                sa, sb = f"{parts[0]}.jpg", f"{parts[1]}.jpg"
                if sa in name_to_idx and sb in name_to_idx:
                    if len(pair_jobs) >= self.max_pairs:
                        break
                    g = f["corres_i2j"][pair_name]
                    pair_jobs.append((
                        len(pair_jobs), name_to_idx[sa], name_to_idx[sb],
                        np.array(g[f"{pair_name}_x.png"]).tobytes(),
                        np.array(g[f"{pair_name}_y.png"]).tobytes(),
                        np.array(g[f"{pair_name}_conf.png"]).tobytes(),
                        int(rng.integers(1, 1 << 62)),
                    ))

        T = self.target_size
        with ThreadPoolExecutor(max_workers=self.decode_threads) as pool:
            rgb_futs = [pool.submit(dp.preprocess_rgb, b, T) for b in rgb_bytes]
            dep_futs = [
                pool.submit(dp.preprocess_depth, b, T, True) for b in dep_bytes
            ]
            rgb_res = [ft.result() for ft in rgb_futs]
            dep_res = [ft.result() for ft in dep_futs]

            out["images"] = np.stack([r[0] for r in rgb_res])
            out["depth_processed"] = np.stack([d[0] for d in dep_res])
            out["K_to_K_prime"] = np.stack([r[1] for r in rgb_res])
            out["K_prime_to_K"] = np.stack([r[2] for r in rgb_res])
            out["K_gt"] = np.stack(K_gt)
            out["poses_w2c_gt"] = np.stack(poses)
            raws = [d[1] for d in dep_res]

            K = self.sample_num
            P = self.max_pairs
            src_idx = np.zeros(P, np.int32)
            dst_idx = np.zeros(P, np.int32)
            src_coords = np.zeros((P, K, 2), np.float32)
            dst_coords = np.zeros((P, K, 2), np.float32)
            src_depth = np.zeros((P, K), np.float32)
            dst_depth = np.zeros((P, K), np.float32)
            pair_valid = np.zeros(P, np.float32)

            def run_pair(job):
                slot, si, di, xb, yb, cb, seed = job
                return slot, si, di, dp.sample_pair(
                    xb, yb, cb, raws[si], raws[di],
                    K, self.min_corres_conf, seed,
                )

            for slot, si, di, (scs, scd, sds, sdd) in pool.map(
                run_pair, pair_jobs
            ):
                src_idx[slot], dst_idx[slot] = si, di
                src_coords[slot], dst_coords[slot] = scs, scd
                src_depth[slot], dst_depth[slot] = sds, sdd
                pair_valid[slot] = 1.0

        out["src_idx"] = src_idx
        out["dst_idx"] = dst_idx
        out["src_coords"] = src_coords
        out["dst_coords"] = dst_coords
        out["src_depth"] = src_depth
        out["dst_depth"] = dst_depth
        out["pair_valid"] = pair_valid
        out["shared_focal"] = self.shared_focal
        return out


def stack_scenes(scenes: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack per-scene dicts into a batch (leading axis = scene)."""
    batch = {}
    for k in (
        "images", "depth_processed", "K_to_K_prime", "K_prime_to_K", "K_gt",
        "poses_w2c_gt", "src_idx", "dst_idx", "src_coords", "dst_coords",
        "src_depth", "dst_depth", "pair_valid",
    ):
        batch[k] = np.stack([s[k] for s in scenes])
    batch["scene_name"] = [s["scene_name"] for s in scenes]
    batch["shared_focal"] = scenes[0]["shared_focal"]
    return batch
