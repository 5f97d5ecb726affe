"""Bundle adjustment: Levenberg-Marquardt with Schur-complement PCG, on the
device.

Port of ``self_supervise_sfm_tpu/ops/bundle_adjust.py``:

- parameters: per camera [axis-angle (3) | translation (3) | log-focal (1)],
  per point xyz; observations (cam_idx, pt_idx, uv, weight);
- per-observation residuals and Jacobians (``torch.func.jacfwd`` under
  ``vmap``, as the JAX package's ``jax.jacfwd`` under ``jax.vmap``), Huber
  IRLS weights, and the block normal equations [U W; W^T V] summed by
  ``index_add_`` (the JAX ``segment_sum``);
- the 3x3 point blocks eliminated in closed form, the reduced camera system
  solved matrix-free by block-Jacobi preconditioned conjugate gradients;
- the LM accept / reject with ``torch.where``.

With ``cg_rtol = lm_ftol = 0`` (the fixed ``max_iters`` x ``cg_iters``
schedule) the loops read nothing back to the host, so a whole solve is one
stream of launches; each adaptive stop reads one scalar a step. On a card
``index_add_`` sums in an order that varies run to run, so two runs of the
same problem differ by fp32 rounding (``PERF.md`` gives the spread).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from . import geometry as G


@dataclass(frozen=True)
class BAConfig:
    max_iters: int = 30
    cg_iters: int = 40
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-9
    max_lambda: float = 1e6
    optimize_focal: bool = False
    huber_delta: float = 0.0  # 0 => plain least squares
    # adaptive stops (0 disables both: the fixed max_iters x cg_iters schedule)
    cg_rtol: float = 0.0  # CG stop: sqrt(r'Mr) <= rtol * sqrt(r0'Mr0)
    lm_ftol: float = 0.0  # LM stop: accepted relative cost decrease < ftol

    @property
    def cam_dim(self) -> int:
        return 7 if self.optimize_focal else 6


class BAProblem(NamedTuple):
    """cam_params (C, 7) = [axis-angle, t, log_f]; intrinsics (C, 3, 3)
    (focal scaled by exp(log_f)); points (P, 3); cam_idx / pt_idx (O,)
    int64; uv (O, 2) pixels; weight (O,) (0: ignored)."""

    cam_params: torch.Tensor
    intrinsics: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    weight: torch.Tensor


def make_problem(extrinsics, intrinsics, points, cam_idx, pt_idx, uv,
                 weight: Optional[torch.Tensor] = None) -> BAProblem:
    """A problem from (C, 3, 4) w2c extrinsics, (C, 3, 3) intrinsics, (P, 3)
    points and the observation lists, on the tensors' device."""
    aa = G.mat_to_axis_angle(extrinsics[..., :3, :3])
    logf = torch.zeros((extrinsics.shape[0], 1), dtype=extrinsics.dtype,
                       device=extrinsics.device)
    cam_params = torch.cat([aa, extrinsics[..., :3, 3], logf], dim=-1)
    if weight is None:
        weight = torch.ones(uv.shape[0], dtype=uv.dtype, device=uv.device)
    return BAProblem(cam_params, intrinsics, points, cam_idx.long(), pt_idx.long(), uv,
                     weight)


def extrinsics_from_params(cam_params: torch.Tensor) -> torch.Tensor:
    R = G.axis_angle_to_mat(cam_params[..., :3])
    return torch.cat([R, cam_params[..., 3:6, None]], dim=-1)


def _project_one(cam, K, point):
    """cam (7,), K (3, 3), point (3,) -> (2,) pixel."""
    R = G.axis_angle_to_mat(cam[:3])
    pc = R @ point + cam[3:6]
    f_scale = torch.exp(cam[6])
    z = torch.clamp(pc[2], min=1e-6)
    u = K[0, 0] * f_scale * (pc[0] / z) + K[0, 2]
    v = K[1, 1] * f_scale * (pc[1] / z) + K[1, 2]
    return torch.stack([u, v])


def _residuals(problem: BAProblem) -> torch.Tensor:
    """Per-observation weighted residual (O, 2)."""
    pred = vmap(_project_one)(problem.cam_params[problem.cam_idx],
                              problem.intrinsics[problem.cam_idx],
                              problem.points[problem.pt_idx])
    return (pred - problem.uv) * problem.weight[:, None]


@G.f32_matmul
def reprojection_rmse(problem: BAProblem) -> torch.Tensor:
    r = _residuals(problem)
    n = torch.clamp((problem.weight > 0).sum(), min=1)
    return torch.sqrt((r * r).sum() / n)


def _robust_scale(r2, delta):
    """Huber IRLS weight on squared residual norms."""
    if delta <= 0:
        return torch.ones_like(r2)
    r = torch.sqrt(r2 + 1e-12)
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def gauge_mask(problem: BAProblem, cfg: BAConfig = BAConfig(),
               fix_first_camera: bool = True, fix_scale: bool = True) -> torch.Tensor:
    """(C, cam_dim) free-parameter mask removing the 7-dof gauge freedom as
    COLMAP does: camera 0 frozen and, with ``fix_scale``, camera 1's
    largest-|t| translation component."""
    cp = problem.cam_params
    C = cp.shape[0]
    mask = torch.ones((C, cfg.cam_dim), dtype=cp.dtype, device=cp.device)
    if fix_first_camera:
        mask[0] = 0.0
    if fix_scale and C > 1:
        comp = cp[1, 3:6].abs().argmax()
        mask[1, 3 + comp] = 0.0
    return mask


def _segment_sum(values, idx, n):
    out = torch.zeros((n, *values.shape[1:]), dtype=values.dtype, device=values.device)
    return out.index_add_(0, idx, values)


@G.f32_matmul
def bundle_adjust(problem: BAProblem, cfg: BAConfig = BAConfig(),
                  free_mask: Optional[torch.Tensor] = None,
                  device="cuda") -> Tuple[BAProblem, dict]:
    """Run LM on ``device`` (where the problem's tensors must live); returns
    (refined problem, info).

    ``free_mask``: optional (C, cam_dim) 0/1 mask of free camera parameters
    (:func:`gauge_mask`); masked dims get no update, which keeps the CG
    solve in the gauge-fixed subspace. ``info``: ``initial_cost`` and
    ``final_cost`` (0-d tensors on the device), ``iterations`` (an int) and
    ``lambda``.
    """
    from ..models.sailrecon import _device

    dev = _device(device)
    if problem.cam_params.device.type != dev.type:
        raise ValueError(f"the problem lives on {problem.cam_params.device}, "
                         f"the solve runs on {dev}")
    C = problem.cam_params.shape[0]
    P = problem.points.shape[0]
    cd = cfg.cam_dim
    dtype = problem.cam_params.dtype
    cam_idx, pt_idx = problem.cam_idx, problem.pt_idx
    fmask = None if free_mask is None else free_mask.to(dtype)

    def f(cam_sub, p, cam7, K, uv, w):
        cam_full = cam_sub if cfg.optimize_focal else torch.cat([cam_sub, cam7[6:7]])
        r = (_project_one(cam_full, K, p) - uv) * w
        return r, r

    def one_obs(cam7, K, pt, uv, w):
        (Jc, Jp), r = jacfwd(f, argnums=(0, 1), has_aux=True)(cam7[:cd], pt, cam7, K, uv, w)
        return r, Jc, Jp

    def cost_and_system(cam_params, points):
        r, Jc, Jp = vmap(one_obs)(cam_params[cam_idx], problem.intrinsics[cam_idx],
                                  points[pt_idx], problem.uv, problem.weight)
        sr = torch.sqrt(_robust_scale((r * r).sum(-1), cfg.huber_delta))[:, None]
        r = r * sr
        Jc = Jc * sr[..., None]
        Jp = Jp * sr[..., None]
        cost = 0.5 * (r * r).sum()
        U = _segment_sum(torch.einsum("oik,oil->okl", Jc, Jc), cam_idx, C)
        V = _segment_sum(torch.einsum("oik,oil->okl", Jp, Jp), pt_idx, P)
        bc = _segment_sum(torch.einsum("oik,oi->ok", Jc, r), cam_idx, C)
        bp = _segment_sum(torch.einsum("oik,oi->ok", Jp, r), pt_idx, P)
        W = torch.einsum("oik,oil->okl", Jc, Jp)  # (O, cd, 3)
        return cost, (U, V, bc, bp, W)

    eye_c = torch.eye(cd, dtype=dtype, device=dev)
    eye_p = torch.eye(3, dtype=dtype, device=dev)

    def solve_schur(U, V, bc, bp, W, lam):
        U_l = U + lam * eye_c
        V_l = V + lam * eye_p
        # inv_ex: no check of the factorization, so no read back to the host
        V_inv = torch.linalg.inv_ex(V_l + 1e-12 * eye_p)[0]  # (P, 3, 3)
        t = torch.einsum("okl,ol->ok", W, (V_inv @ bp[..., None])[pt_idx, :, 0])
        rhs = -bc + _segment_sum(t, cam_idx, C)
        if fmask is not None:
            rhs = rhs * fmask

        def S_matvec(x):  # (C, cd)
            if fmask is not None:
                x = x * fmask
            wtx = torch.einsum("okl,ok->ol", W, x[cam_idx])
            zp = (V_inv @ _segment_sum(wtx, pt_idx, P)[..., None])[..., 0]
            wz = torch.einsum("okl,ol->ok", W, zp[pt_idx])
            Sx = torch.einsum("ckl,cl->ck", U_l, x) - _segment_sum(wz, cam_idx, C)
            # identity on the fixed dims keeps CG well-posed
            if fmask is not None:
                Sx = Sx * fmask + x * (1.0 - fmask)
            return Sx

        U_inv = torch.linalg.inv_ex(U_l + 1e-12 * eye_c)[0]

        def precond(x):
            z = torch.einsum("ckl,cl->ck", U_inv, x)
            if fmask is not None:
                z = z * fmask + x * (1.0 - fmask)
            return z

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rr)
        rz = (rr * p).sum()
        tol2 = (cfg.cg_rtol ** 2) * rz
        for _ in range(cfg.cg_iters):
            # the adaptive stop reads one scalar a step; the fixed schedule none
            if cfg.cg_rtol > 0 and not bool(rz > tol2):
                break
            Ap = S_matvec(p)
            alpha = rz / torch.clamp((p * Ap).sum(), min=1e-20)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.clamp(rz, min=1e-20)
            p = z + beta * p
            rz = rz_new
        dc = x
        wtdc = torch.einsum("okl,ok->ol", W, dc[cam_idx])
        dp = (V_inv @ (-bp - _segment_sum(wtdc, pt_idx, P))[..., None])[..., 0]
        return dc, dp

    def apply_step(cam_params, points, dc, dp):
        if cfg.optimize_focal:
            cam_new = cam_params + dc
        else:
            cam_new = torch.cat([cam_params[:, :6] + dc, cam_params[:, 6:]], dim=1)
        return cam_new, points + dp

    cam_params, points = problem.cam_params, problem.points
    init_cost, _ = cost_and_system(cam_params, points)
    lam = torch.tensor(cfg.init_lambda, dtype=torch.float32, device=dev)
    cost = init_cost
    it = 0
    while it < cfg.max_iters:
        cost0, (U, V, bc, bp, W) = cost_and_system(cam_params, points)
        dc, dp = solve_schur(U, V, bc, bp, W, lam)
        cam_new, pts_new = apply_step(cam_params, points, dc, dp)
        cost_new, _ = cost_and_system(cam_new, pts_new)
        accept = cost_new < cost0
        cam_params = torch.where(accept, cam_new, cam_params)
        points = torch.where(accept, pts_new, points)
        lam = torch.clamp(torch.where(accept, lam * cfg.lambda_down, lam * cfg.lambda_up),
                          cfg.min_lambda, cfg.max_lambda)
        # a trial that lands on NaN (a step through a camera plane) is
        # rejected above; fmin keeps it out of the reported cost
        cost = torch.fmin(cost0, cost_new)
        it += 1
        if cfg.lm_ftol > 0:
            # an accepted step that no longer moves the cost: converged
            rel = (cost0 - cost_new) / torch.clamp(cost0, min=1e-30)
            if bool(accept & (rel < cfg.lm_ftol)):
                break
    refined = problem._replace(cam_params=cam_params, points=points)
    return refined, {"initial_cost": init_cost, "final_cost": cost, "iterations": it,
                     "lambda": lam}
