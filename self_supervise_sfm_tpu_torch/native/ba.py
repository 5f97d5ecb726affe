"""ctypes binding to the native C++ bundle-adjustment engine (``cpp/ba``).

Port of ``self_supervise_sfm_tpu/native/ba.py``: the dense and block-sparse
PCG LM-Schur solvers (:func:`ba_solve`) and the point-partitioned engine
(:class:`BAShard`, :func:`ba_solve_distributed`, reduced on one host in
numpy). The library is compiled with g++ at first use, from
``cpp/ba/ba_engine.cpp`` into ``build/ba/``, under a name keyed by the
source's sha256, so a changed source rebuilds; nothing is written under
``cpp/``. The engine runs on the host in float64; the port's on-device
solver is ``ops/bundle_adjust.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "cpp", "ba", "ba_engine.cpp")
_BUILD = os.path.join(_ROOT, "build", "ba")
# the JAX package's flags, so that both bindings run the same machine code
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _np_mat_to_axis_angle(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) -> (N, 3) axis-angle, pure numpy (float64).

    The engine's front end, in float64 on the host.
    """
    R = np.asarray(R, np.float64)
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)  # (N,)
    w = np.stack(
        [R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
         R[:, 1, 0] - R[:, 0, 1]], axis=-1,
    )
    sin_t = np.sin(theta)
    small = theta < 1e-6
    near_pi = theta > np.pi - 1e-4
    scale = np.where(small | near_pi, 0.5, theta / np.maximum(2.0 * sin_t, 1e-30))
    aa = w * scale[:, None]
    if near_pi.any():
        # theta ~ pi: axis from the symmetric part, sign from w
        for i in np.nonzero(near_pi)[0]:
            A = (R[i] + np.eye(3)) / 2.0
            ax = np.sqrt(np.clip(np.diag(A), 0.0, None))
            k = int(np.argmax(ax))
            if ax[k] > 0:
                ax = A[:, k] / ax[k]
                n = np.linalg.norm(ax)
                if n > 0:
                    ax = ax / n
            sgn = np.sign(w[i] @ ax)
            if sgn == 0:
                sgn = 1.0
            aa[i] = sgn * ax * theta[i]
    return aa


def _np_axis_angle_to_mat(aa: np.ndarray) -> np.ndarray:
    """(N, 3) -> (N, 3, 3) Rodrigues, pure numpy (float64)."""
    aa = np.asarray(aa, np.float64)
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)  # (N, 1)
    k = aa / np.maximum(theta, 1e-30)
    K = np.zeros(aa.shape[:-1] + (3, 3))
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    R = np.eye(3) + st * K + (1.0 - ct) * (K @ K)
    R[theta[:, 0] < 1e-12] = np.eye(3)
    return R


def library_path() -> str:
    """``build/ba/libba_engine_<sha256 of the source, 16 hex>.so``."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libba_engine_{digest}.so")


def build(force: bool = False) -> str:
    """Compile the engine into ``build/ba/`` unless the library for this
    source is there; returns its path."""
    lib = library_path()
    if not force and os.path.exists(lib):
        return lib
    os.makedirs(_BUILD, exist_ok=True)
    # compile to a private name, then rename: processes sharing a checkout
    # may race the build, and a partly written library must never load
    tmp = f"{lib}.tmp.{os.getpid()}"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f64 = lambda: np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")  # noqa: E731
            i32 = lambda: np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")  # noqa: E731
            lib.ba_solve.restype = ctypes.c_int
            lib.ba_solve.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f64(), f64(), f64(), i32(), i32(), f64(), f64(),
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
            ]
            lib.ba_shard_create.restype = ctypes.c_void_p
            lib.ba_shard_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f64(), f64(), i32(), i32(), f64(), f64(), ctypes.c_double,
            ]
            lib.ba_shard_destroy.restype = None
            lib.ba_shard_destroy.argtypes = [ctypes.c_void_p]
            lib.ba_shard_linearize.restype = ctypes.c_double
            lib.ba_shard_linearize.argtypes = [
                ctypes.c_void_p, f64(), ctypes.c_double, f64(), f64(),
            ]
            lib.ba_shard_trial.restype = ctypes.c_double
            lib.ba_shard_trial.argtypes = [ctypes.c_void_p, f64(), f64()]
            lib.ba_shard_accept.restype = None
            lib.ba_shard_accept.argtypes = [ctypes.c_void_p]
            lib.ba_shard_get_points.restype = None
            lib.ba_shard_get_points.argtypes = [ctypes.c_void_p, f64()]
            lib.ba_shard_cost.restype = ctypes.c_double
            lib.ba_shard_cost.argtypes = [ctypes.c_void_p, f64()]
            lib.ba_solve_reduced.restype = ctypes.c_int
            lib.ba_solve_reduced.argtypes = [
                f64(), f64(), ctypes.c_int, ctypes.c_double, f64(),
            ]
            lib.ba_apply_cam_step.restype = None
            lib.ba_apply_cam_step.argtypes = [f64(), f64(), ctypes.c_int, f64()]
            lib.ba_solve_pcg.restype = ctypes.c_int
            lib.ba_solve_pcg.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                f64(), f64(), f64(), i32(), i32(), f64(), f64(),
                ctypes.c_int, ctypes.c_double, ctypes.c_double,
                ctypes.c_double, ctypes.c_int,
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
            ]
            _lib = lib
    return _lib


# Above this camera count the dense 6C x 6C reduced system (O(C^2) memory,
# O(C^3) Cholesky) loses to block-sparse Schur + block-Jacobi PCG; measured
# crossover is a few hundred cameras (the JAX package's tools/ba_benchmark.py).
SPARSE_CAMERA_THRESHOLD = 300


def ba_solve(
    extrinsics: np.ndarray,  # (C, 3, 4) w2c
    intrinsics: np.ndarray,  # (C, 3, 3)
    points: np.ndarray,  # (P, 3)
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    weight: Optional[np.ndarray] = None,
    max_iters: int = 30,
    init_lambda: float = 1e-3,
    huber_delta: float = 0.0,
    solver: str = "auto",  # auto | dense | pcg
    cg_tol: float = 1e-6,
    cg_maxit: int = 500,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Run the native LM-Schur solver; returns (extrinsics, points, info).

    ``solver='auto'`` uses the dense Cholesky reduced system for small scenes
    and switches to block-sparse Schur + PCG past
    ``SPARSE_CAMERA_THRESHOLD`` cameras (the COLMAP-scale regime the
    reference reaches through pycolmap, ``dependency/np_to_pycolmap.py``).
    """
    lib = _load()
    C = extrinsics.shape[0]
    cam, K4, pts, cam_idx, pt_idx, uv, weight = _prep_problem(
        extrinsics, intrinsics, points, cam_idx, pt_idx, uv, weight
    )
    final_cost = ctypes.c_double(0.0)
    iters_run = ctypes.c_int(0)
    if solver == "auto":
        solver = "pcg" if C > SPARSE_CAMERA_THRESHOLD else "dense"
    info: dict
    if solver == "pcg":
        cg_total = ctypes.c_int(0)
        nnz = ctypes.c_int64(0)
        ret = lib.ba_solve_pcg(
            C, pts.shape[0], len(uv),
            cam, K4, pts,
            cam_idx, pt_idx, uv, weight,
            max_iters, init_lambda, huber_delta, cg_tol, cg_maxit,
            ctypes.byref(final_cost), ctypes.byref(iters_run),
            ctypes.byref(cg_total), ctypes.byref(nnz),
        )
        info = {"solver": "pcg", "cg_iterations": cg_total.value,
                "nnz_blocks": nnz.value}
    else:
        ret = lib.ba_solve(
            C, pts.shape[0], len(uv),
            cam, K4, pts,
            cam_idx, pt_idx, uv, weight,
            max_iters, init_lambda, huber_delta,
            ctypes.byref(final_cost), ctypes.byref(iters_run),
        )
        info = {"solver": "dense"}
    assert ret == 0
    R = _np_axis_angle_to_mat(cam[:, :3]).astype(np.float32)
    ext = np.concatenate([R, cam[:, 3:6, None].astype(np.float32)], axis=2)
    info.update({
        "final_cost": final_cost.value,
        "iterations": iters_run.value,
    })
    return ext, pts.astype(np.float32), info


# ---------------------------------------------------------------------------
# Distributed (sharded) solver
# ---------------------------------------------------------------------------


class BAShard:
    """One worker's slice: all cameras (shared), a partition of the points
    and every observation of those points (point elimination is local)."""

    def __init__(self, num_cams, intrinsics4, points, cam_idx, pt_idx_local,
                 uv, weight, huber_delta):
        self._lib = _load()
        self.C = int(num_cams)
        self.P = int(points.shape[0])
        self.O = int(len(uv))
        self._pts_buf = np.ascontiguousarray(points.astype(np.float64))
        self._h = self._lib.ba_shard_create(
            self.C, self.P, self.O,
            np.ascontiguousarray(intrinsics4.astype(np.float64)),
            self._pts_buf,
            np.ascontiguousarray(cam_idx.astype(np.int32)),
            np.ascontiguousarray(pt_idx_local.astype(np.int32)),
            np.ascontiguousarray(uv.astype(np.float64)),
            np.ascontiguousarray(weight.astype(np.float64)),
            float(huber_delta),
        )

    def linearize(self, cam, lam):
        """Returns (S_partial (6C,6C), rhs_partial (6C,), cost) — additive."""
        n = 6 * self.C
        S = np.zeros((n, n), np.float64)
        rhs = np.zeros(n, np.float64)
        cost = self._lib.ba_shard_linearize(
            self._h, np.ascontiguousarray(cam), float(lam), S, rhs
        )
        return S, rhs, cost

    def trial(self, cam_new, dc):
        return self._lib.ba_shard_trial(
            self._h, np.ascontiguousarray(cam_new), np.ascontiguousarray(dc)
        )

    def accept(self):
        self._lib.ba_shard_accept(self._h)

    def points(self):
        out = np.empty((self.P, 3), np.float64)
        self._lib.ba_shard_get_points(self._h, out)
        return out

    def cost(self, cam):
        return self._lib.ba_shard_cost(self._h, np.ascontiguousarray(cam))

    def close(self):
        if self._h:
            self._lib.ba_shard_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def solve_reduced(S, rhs, lam):
    """x = (S + lam I)^-1 rhs via the native Cholesky; None if not SPD."""
    lib = _load()
    n = rhs.shape[0]
    dx = np.empty(n, np.float64)
    ok = lib.ba_solve_reduced(
        np.ascontiguousarray(S), np.ascontiguousarray(rhs), n, float(lam), dx
    )
    return dx if ok == 0 else None


def apply_cam_step(cam, dc):
    lib = _load()
    out = np.empty_like(cam)
    lib.ba_apply_cam_step(
        np.ascontiguousarray(cam), np.ascontiguousarray(dc), cam.shape[0], out
    )
    return out



def _prep_problem(extrinsics, intrinsics, points, cam_idx, pt_idx, uv, weight):
    """Shared front-end of every solver: (axis-angle|t) camera params, the
    4-vector intrinsics, and contiguous float64/int32 problem arrays."""
    aa = _np_mat_to_axis_angle(extrinsics[:, :3, :3])
    cam = np.ascontiguousarray(
        np.concatenate([aa, extrinsics[:, :3, 3]], axis=1).astype(np.float64)
    )
    K4 = np.ascontiguousarray(
        np.stack(
            [intrinsics[:, 0, 0], intrinsics[:, 1, 1],
             intrinsics[:, 0, 2], intrinsics[:, 1, 2]],
            axis=1,
        ).astype(np.float64)
    )
    if weight is None:
        weight = np.ones(len(uv))
    return (
        cam, K4,
        np.ascontiguousarray(points.astype(np.float64)),
        np.ascontiguousarray(np.asarray(cam_idx, np.int32)),
        np.ascontiguousarray(np.asarray(pt_idx, np.int32)),
        np.ascontiguousarray(np.asarray(uv, np.float64)),
        np.ascontiguousarray(np.asarray(weight, np.float64)),
    )


def _gauge_rows(cam, gauge_fix: bool) -> np.ndarray:
    """Reduced-system rows to pin: camera 0 entirely + camera 1's largest-|t|
    translation component (global scale) — COLMAP-style, same convention as
    ``ops.bundle_adjust.gauge_mask``."""
    if not gauge_fix:
        return np.empty(0, np.int64)
    fixed = np.arange(6)
    if cam.shape[0] > 1:
        comp = int(np.argmax(np.abs(cam[1, 3:6])))
        fixed = np.concatenate([fixed, [6 + 3 + comp]])
    return fixed


def _lm_loop(shards, reduce3, cam, fixed_rows, max_iters, init_lambda):
    """The LM accept/reject drive over point-partitioned shards.

    ``reduce3(S_list, rhs_list, cost_list) -> (S, rhs, cost)`` sums the
    additive reduced-system partials across shards. The control flow is
    that of the JAX package's, so that an N-shard run there and here take
    the same steps.
    """
    lam = init_lambda
    cost = float(np.sum([sh.cost(cam) for sh in shards]))
    it = 0
    for it in range(max_iters):
        parts = [sh.linearize(cam, lam) for sh in shards]
        S, rhs, _ = reduce3(
            [p[0] for p in parts], [p[1] for p in parts], [p[2] for p in parts]
        )
        if fixed_rows.size:
            S = np.asarray(S, np.float64).copy()
            rhs = np.asarray(rhs, np.float64).copy()
            S[fixed_rows, :] = 0.0
            S[:, fixed_rows] = 0.0
            S[fixed_rows, fixed_rows] = 1.0
            rhs[fixed_rows] = 0.0
        dc = solve_reduced(S, rhs, lam)
        if dc is None:
            lam *= 10.0
            continue
        cam_new = apply_cam_step(cam, dc)
        new_cost = float(np.sum([sh.trial(cam_new, dc) for sh in shards]))
        if new_cost < cost:
            cost = new_cost
            lam = max(lam * 0.5, 1e-9)
            cam = cam_new
            for sh in shards:
                sh.accept()
        else:
            lam = min(lam * 4.0, 1e8)
    return cam, cost, it


def ba_solve_multihost(*args, **kwargs):
    """Distributed BA across processes: not ported yet (slice 6, multi-device,
    ``ROADMAP.md`` Queue A item 7). :func:`ba_solve_distributed` runs the
    same point-partitioned engine in one process."""
    raise NotImplementedError(
        "ba_solve_multihost is not ported yet: it comes with slice 6 "
        "(multi-device, ROADMAP.md Queue A item 7); ba_solve_distributed runs "
        "the sharded engine in one process")


def ba_solve_distributed(
    extrinsics: np.ndarray,  # (C, 3, 4) w2c
    intrinsics: np.ndarray,  # (C, 3, 3)
    points: np.ndarray,  # (P, 3)
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    weight: Optional[np.ndarray] = None,
    num_shards: int = 2,
    max_iters: int = 30,
    init_lambda: float = 1e-3,
    huber_delta: float = 0.0,
    reduce_fn=None,
    gauge_fix: bool = False,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Multi-worker LM-Schur BA in one process.

    Points are partitioned round-robin over ``num_shards`` workers; each
    worker eliminates its own 3x3 point blocks and contributes an additive
    partial (S_w, rhs_w, cost_w) to the shared 6C x 6C reduced camera
    system. ``reduce_fn(S_list, rhs_list, cost_list) -> (S, rhs, cost)``
    performs the cross-worker reduction: the default sums in numpy. The LM
    control (damping, accept/reject) is driven
    here and is bit-identical to the single-shard ``ba_solve`` path.

    ``gauge_fix``: remove the 7-dof gauge freedom COLMAP-style — freeze
    camera 0 entirely and camera 1's largest-|t| translation component
    (pins global scale; same convention as ``ops.bundle_adjust.gauge_mask``)
    by pinning those rows/cols of the reduced camera system.
    """
    C = extrinsics.shape[0]
    P = points.shape[0]
    cam, K4, points, cam_idx, pt_idx, uv, weight = _prep_problem(
        extrinsics, intrinsics, points, cam_idx, pt_idx, uv, weight
    )

    # round-robin point partition; each point's observations follow it
    owner = np.arange(P) % num_shards
    local_idx = np.arange(P) // num_shards
    shards = []
    shard_point_global = []
    for w in range(num_shards):
        sel_p = np.where(owner == w)[0]
        sel_o = np.where(owner[pt_idx] == w)[0]
        shard_point_global.append(sel_p)
        shards.append(
            BAShard(
                C, K4, points[sel_p].astype(np.float64),
                cam_idx[sel_o], local_idx[pt_idx[sel_o]].astype(np.int32),
                uv[sel_o], weight[sel_o], huber_delta,
            )
        )

    if reduce_fn is None:
        def reduce_fn(S_list, rhs_list, cost_list):
            return (
                np.sum(S_list, axis=0),
                np.sum(rhs_list, axis=0),
                float(np.sum(cost_list)),
            )

    fixed_rows = _gauge_rows(cam, gauge_fix)
    cam, cost, it = _lm_loop(shards, reduce_fn, cam, fixed_rows, max_iters, init_lambda)

    pts_out = np.empty((P, 3), np.float64)
    for w, sh in enumerate(shards):
        pts_out[shard_point_global[w]] = sh.points()
        sh.close()
    R = _np_axis_angle_to_mat(cam[:, :3]).astype(np.float32)
    ext = np.concatenate([R, cam[:, 3:6, None].astype(np.float32)], axis=2)
    return ext, pts_out.astype(np.float32), {
        "final_cost": cost,
        "iterations": it + 1,
        "num_shards": num_shards,
    }
