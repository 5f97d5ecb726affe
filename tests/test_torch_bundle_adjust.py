"""PyTorch port: the bundle adjuster and the native engine's binding against
the JAX package.

``ops/bundle_adjust.py`` on ``tests/test_bundle_adjust.py``'s synthetic
scene (6 cameras on a ring, 120 points, 0.5 px noise, perturbed poses and
points), through the JAX solver (jitted, fp32) and the port's (fp32, on the
CPU). The fixed schedule (``cg_rtol = lm_ftol = 0``) takes the same steps
in both: final cost within 1e-4 relative, and with the gauge fixed the
cameras and points within 1e-3. Without gauge fixing the problem has a
7-dof null space along which fp32 rounding drifts the two solvers apart
(the cost is flat there), so those cases compare the cost and the
gauge-invariant reprojections (1e-3 px) instead of the parameters. The
adaptive stops take the same iteration counts. ``native/ba.py``: the port's
binding builds its own library under ``build/ba/`` and, on one library and
one OpenMP thread, gives the JAX binding's result bit for bit; the
committed library of the JAX package (built elsewhere, with other FMA
contractions) agrees within 1e-9 relative.
"""

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.native import ba as JNBA
from self_supervise_sfm_tpu.ops import bundle_adjust as JBA
from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu.utils import colmap_io as JC
from self_supervise_sfm_tpu_torch.native import ba as TNBA
from self_supervise_sfm_tpu_torch.ops import bundle_adjust as TBA
from self_supervise_sfm_tpu_torch.utils import colmap_io as TC
from tests.test_bundle_adjust import make_ba_scene

torch.set_num_threads(1)
# the demo's schedule (BAConfig(max_iters=20, huber_delta=4.0), 40 CG steps)
FAST = dict(max_iters=20, cg_iters=40)


def _scene(seed=0, C=6, P=120):
    rng = np.random.default_rng(seed)
    exts, Ks, pts, ci, pi, uv = make_ba_scene(rng, C=C, P=P, noise_px=0.5)
    exts_n = exts.copy()
    for c in range(1, C):
        dR = np.asarray(JG.axis_angle_to_mat(jnp.asarray(
            rng.normal(scale=0.02, size=3).astype(np.float32))))
        exts_n[c, :3, :3] = dR @ exts_n[c, :3, :3]
        exts_n[c, :3, 3] += rng.normal(scale=0.03, size=3).astype(np.float32)
    pts_n = (pts + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)
    return exts_n, Ks, pts_n, ci, pi, uv


def _problems(scene):
    jp = JBA.make_problem(*(jnp.asarray(a) for a in scene))
    tp = TBA.make_problem(*(torch.from_numpy(np.asarray(a)) for a in scene))
    return jp, tp


def _pixels(M, cam_params, intr, pts, ci, pi):
    """Every observation's projection, in package M's arithmetic."""
    if M is TBA:
        return torch.func.vmap(TBA._project_one)(cam_params[ci], intr[ci], pts[pi]).numpy()
    return np.asarray(jax.vmap(JBA._project_one)(cam_params[ci], intr[ci], pts[pi]))


@pytest.mark.parametrize("huber,gauge", [(0.0, False), (4.0, True)])
def test_fixed_schedule_matches_jax(huber, gauge):
    scene = _scene()
    jp, tp = _problems(scene)
    np.testing.assert_allclose(tp.cam_params.numpy(), np.asarray(jp.cam_params), atol=1e-5)
    np.testing.assert_allclose(float(TBA.reprojection_rmse(tp)),
                               float(JBA.reprojection_rmse(jp)), rtol=1e-5)
    jcfg, tcfg = JBA.BAConfig(huber_delta=huber, **FAST), TBA.BAConfig(huber_delta=huber, **FAST)
    jm = JBA.gauge_mask(jp, jcfg) if gauge else None
    tm = TBA.gauge_mask(tp, tcfg) if gauge else None
    if gauge:
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jr, ji = JBA.bundle_adjust(jp, jcfg, free_mask=jm)
    tr, ti = TBA.bundle_adjust(tp, tcfg, free_mask=tm, device="cpu")
    assert ti["iterations"] == int(ji["iterations"]) == FAST["max_iters"]
    np.testing.assert_allclose(float(ti["initial_cost"]), float(ji["initial_cost"]), rtol=1e-5)
    np.testing.assert_allclose(float(ti["final_cost"]), float(ji["final_cost"]), rtol=1e-4)
    assert float(ti["final_cost"]) < 0.1 * float(ti["initial_cost"])
    if gauge:
        np.testing.assert_allclose(tr.cam_params.numpy(), np.asarray(jr.cam_params), atol=1e-3)
        np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=1e-3)
    ci, pi = scene[3], scene[4]
    np.testing.assert_allclose(
        _pixels(TBA, tr.cam_params, tr.intrinsics, tr.points, tp.cam_idx, tp.pt_idx),
        _pixels(JBA, jr.cam_params, jr.intrinsics, jr.points, ci, pi), atol=1e-3)


def test_adaptive_stops_match_jax():
    jp, tp = _problems(_scene(seed=1))
    kw = dict(max_iters=30, cg_iters=40, cg_rtol=1e-2, lm_ftol=1e-4)
    jr, ji = JBA.bundle_adjust(jp, JBA.BAConfig(**kw), free_mask=JBA.gauge_mask(jp))
    tr, ti = TBA.bundle_adjust(tp, TBA.BAConfig(**kw), free_mask=TBA.gauge_mask(tp),
                               device="cpu")
    assert ti["iterations"] == int(ji["iterations"]) < kw["max_iters"]
    np.testing.assert_allclose(float(ti["final_cost"]), float(ji["final_cost"]), rtol=1e-4)
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=1e-3)


def test_optimize_focal_matches_jax():
    jp, tp = _problems(_scene(seed=2, C=3, P=30))
    kw = dict(optimize_focal=True, max_iters=3, cg_iters=10)
    jr, ji = JBA.bundle_adjust(jp, JBA.BAConfig(**kw), free_mask=JBA.gauge_mask(
        jp, JBA.BAConfig(**kw)))
    tr, ti = TBA.bundle_adjust(tp, TBA.BAConfig(**kw), free_mask=TBA.gauge_mask(
        tp, TBA.BAConfig(**kw)), device="cpu")
    np.testing.assert_allclose(float(ti["final_cost"]), float(ji["final_cost"]), rtol=1e-4)
    np.testing.assert_allclose(tr.cam_params.numpy(), np.asarray(jr.cam_params), atol=1e-3)


def _reconstructions():
    scene = _scene(seed=3, C=4, P=50)
    exts, Ks, pts, ci, pi, uv = scene
    tracks = np.zeros((4, 50, 2), np.float32)
    for c, p, xy in zip(ci, pi, uv):
        tracks[c, p] = xy
    masks = np.ones((4, 50), bool)
    kw = dict(image_size=(256, 192), min_inlier_per_frame=8)
    j, _ = JC.batch_matrix_to_reconstruction(pts, None, tracks, masks, exts, Ks, **kw)
    t, _ = TC.batch_matrix_to_reconstruction(pts, None, tracks, masks, exts, Ks, **kw)
    return j, t


def test_refine_matches_jax():
    j, t = _reconstructions()
    JC.refine(j, JBA.BAConfig(**FAST, huber_delta=4.0))
    TC.refine(t, TBA.BAConfig(**FAST, huber_delta=4.0), device="cpu")
    for a, b in zip(TC.reconstruction_to_batch_matrix(t), JC.reconstruction_to_batch_matrix(j)):
        np.testing.assert_allclose(a, b, atol=1e-3)


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, tp = _problems(_scene(C=3, P=10))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TBA.bundle_adjust(tp)
    _, t = _reconstructions()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.refine(t)


# -- the native engine's binding -------------------------------------------------


@pytest.fixture
def one_library_one_thread(monkeypatch):
    """Both bindings on the port's library (built under build/ba/), with
    one OpenMP thread: its dynamic schedules then sum in one order."""
    path = TNBA.build()
    assert path.startswith(os.path.join(TNBA._ROOT, "build", "ba"))
    monkeypatch.setattr(JNBA, "build", lambda force=False: path)
    monkeypatch.setattr(JNBA, "_lib", None)
    lib = TNBA._load()
    lib.omp_get_max_threads.restype = ctypes.c_int
    saved = lib.omp_get_max_threads()
    lib.omp_set_num_threads(1)
    yield
    lib.omp_set_num_threads(saved)


def _native_inputs():
    rng = np.random.default_rng(0)
    exts, Ks, pts, ci, pi, uv = make_ba_scene(rng, C=6, P=120, noise_px=0.5)
    pts_n = (pts + rng.normal(scale=0.05, size=pts.shape)).astype(np.float32)
    return exts, Ks, pts_n, ci, pi, uv


@pytest.mark.parametrize("solver", ["dense", "pcg", "distributed"])
def test_native_binding_bit_equal_to_jax(one_library_one_thread, solver):
    args = _native_inputs()
    if solver == "distributed":
        kw = dict(num_shards=2, huber_delta=4.0, gauge_fix=True)
        a = JNBA.ba_solve_distributed(*args, **kw)
        b = TNBA.ba_solve_distributed(*args, **kw)
    else:
        a = JNBA.ba_solve(*args, huber_delta=4.0, solver=solver)
        b = TNBA.ba_solve(*args, huber_delta=4.0, solver=solver)
    np.testing.assert_array_equal(b[0], a[0])
    np.testing.assert_array_equal(b[1], a[1])
    assert b[2] == a[2]


def test_native_binding_agrees_with_the_committed_library():
    """The JAX package's committed ``cpp/ba/libba_engine.so`` (its own
    build) against the port's, each with its own threads."""
    args = _native_inputs()
    a = JNBA.ba_solve(*args, huber_delta=4.0)
    b = TNBA.ba_solve(*args, huber_delta=4.0)
    assert a[2]["iterations"] == b[2]["iterations"]
    np.testing.assert_allclose(b[2]["final_cost"], a[2]["final_cost"], rtol=1e-9)
    np.testing.assert_allclose(b[1], a[1], atol=1e-5)


def test_native_build_stays_out_of_cpp():
    path = TNBA.build()
    assert os.path.dirname(path) == os.path.join(TNBA._ROOT, "build", "ba")
    assert os.path.basename(path).startswith("libba_engine_")
    with pytest.raises(NotImplementedError, match="slice 6"):
        TNBA.ba_solve_multihost()
