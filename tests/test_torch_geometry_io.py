"""PyTorch port: geometry, trajectory evaluation and COLMAP I/O against the
JAX package.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``self_supervise_sfm_tpu_torch``. Geometry runs in fp32 in
both packages: 1e-5 absolute (radians / normalised units; pixels at 1e-5
relative). ``utils/evaluation.py`` is numpy in both: 1e-10. The COLMAP
models that both packages write from one reconstruction are byte-equal, and
each package reads the other's.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu.utils import colmap_io as JC
from self_supervise_sfm_tpu.utils import evaluation as JE
from self_supervise_sfm_tpu_torch.ops import geometry as TG
from self_supervise_sfm_tpu_torch.utils import colmap_io as TC
from self_supervise_sfm_tpu_torch.utils import evaluation as TE

torch.set_num_threads(1)
ATOL = 1e-5


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(JG.quat_to_mat(jnp.asarray(q, jnp.float32)))


def _poses(rng, n):
    R = _rotations(rng, n)
    t = rng.normal(size=(n, 3, 1)).astype(np.float32)
    return np.concatenate([R, t], axis=-1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, jax_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(jax_out), atol=atol, rtol=rtol)


# -- geometry -----------------------------------------------------------------


def test_unpad_and_standardize(rng):
    P = rng.normal(size=(3, 4, 4)).astype(np.float32)
    _close(TG.unpad_poses(_t(P)), JG.unpad_poses(jnp.asarray(P)), atol=0)
    q = rng.normal(size=(7, 4)).astype(np.float32)
    _close(TG.standardize_quaternion(_t(q)), JG.standardize_quaternion(jnp.asarray(q)), atol=0)


@pytest.mark.parametrize("kind", ["random", "near_identity", "near_pi"])
def test_mat_to_quat_and_axis_angle(rng, kind):
    """Every branch of the quaternion pick: random rotations, ones near the
    identity (the w branch) and near a half turn (the x / y / z branches)."""
    if kind == "random":
        R = _rotations(rng, 64)
    else:
        aa = rng.normal(size=(64, 3))
        aa /= np.linalg.norm(aa, axis=-1, keepdims=True)
        aa *= 1e-3 if kind == "near_identity" else np.pi - 1e-3
        R = np.asarray(JG.axis_angle_to_mat(jnp.asarray(aa, jnp.float32)))
    _close(TG.mat_to_quat(_t(R)), JG.mat_to_quat(jnp.asarray(R)))
    _close(TG.mat_to_axis_angle(_t(R)), JG.mat_to_axis_angle(jnp.asarray(R)), atol=1e-4)


def test_axis_angle_to_mat(rng):
    aa = rng.normal(size=(32, 3)).astype(np.float32)
    aa[:4] *= 1e-7  # the small-angle forms
    aa[4] = 0.0
    _close(TG.axis_angle_to_mat(_t(aa)), JG.axis_angle_to_mat(jnp.asarray(aa)))


def test_extri_intri_to_pose_encoding(rng):
    E = _poses(rng, 6)
    K = np.tile(np.array([[300.0, 0, 64], [0, 280.0, 48], [0, 0, 1]], np.float32), (6, 1, 1))
    _close(TG.extri_intri_to_pose_encoding(_t(E), _t(K), (96, 128)),
           JG.extri_intri_to_pose_encoding(jnp.asarray(E), jnp.asarray(K), (96, 128)))


@pytest.mark.parametrize("num_params", [1, 2, 4])
def test_distortion_and_undistortion(rng, num_params):
    params = (rng.normal(size=(5, num_params)) * 0.05).astype(np.float32)
    # normalised coordinates where the distortion is one-to-one: further out,
    # a barrel k1 of -0.1 folds the map, and Newton from either package may
    # settle on different preimages or none within the iterations
    uv = rng.uniform(-0.35, 0.35, size=(5, 40, 2)).astype(np.float32)
    for a, b in zip(TG.apply_distortion(_t(params)[:, None], _t(uv[..., 0]), _t(uv[..., 1])),
                    JG.apply_distortion(jnp.asarray(params)[:, None], jnp.asarray(uv[..., 0]),
                                        jnp.asarray(uv[..., 1]))):
        _close(a, b)
    port = TG.iterative_undistortion(_t(params)[:, None], _t(uv), max_iters=20)
    ref = JG.iterative_undistortion(jnp.asarray(params)[:, None], jnp.asarray(uv), max_iters=20)
    # a point stops once its Newton step is under 1e-5 (step^2 < 1e-10), and
    # the fp32 central-difference Jacobian decides which step that is: the
    # two packages' fixed points agree within twice that stop
    _close(port, ref, atol=2e-5)
    # and it inverts the distortion, to what an fp32 central difference of
    # step 1e-6 |x| lets Newton resolve
    u, v = TG.apply_distortion(_t(params)[:, None], port[..., 0], port[..., 1])
    np.testing.assert_allclose(torch.stack([u, v], -1).numpy(), uv, atol=1e-4)


@pytest.mark.parametrize("distorted", [False, True])
def test_projection(rng, distorted):
    E = _poses(rng, 4)
    E[:, 2, 3] += 6.0  # points in front of the cameras
    K = np.tile(np.array([[300.0, 0, 64], [0, 280.0, 48], [0, 0, 1]], np.float32), (4, 1, 1))
    X = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
    dist = (rng.normal(size=(4, 4)) * 0.02).astype(np.float32) if distorted else None
    pix, cam = TG.project_world_points_to_cam(
        _t(X), _t(E), _t(K), None if dist is None else _t(dist))
    jpix, jcam = JG.project_world_points_to_cam(
        jnp.asarray(X), jnp.asarray(E), jnp.asarray(K),
        None if dist is None else jnp.asarray(dist))
    _close(cam, jcam)
    _close(pix, jpix, rtol=1e-5, atol=1e-4)
    none, cam_only = TG.project_world_points_to_cam(_t(X), _t(E))
    assert none is None and torch.equal(cam_only, cam)
    # a point on the camera plane gives the default instead of a non-finite pixel
    cam_pts = _t(np.zeros((1, 3, 2), np.float32))
    got = TG.img_from_cam(_t(K[:1]), cam_pts - 1e-8 * torch.tensor([0.0, 0.0, 1.0])[:, None],
                          default=-7.0)
    ref = JG.img_from_cam(jnp.asarray(K[:1]), jnp.asarray(cam_pts.numpy())
                          - 1e-8 * jnp.asarray([0.0, 0.0, 1.0])[:, None], default=-7.0)
    _close(got, ref, atol=0)


# -- evaluation (numpy in both packages) ---------------------------------------


def test_evaluation_matches_jax(rng):
    gt = _poses(rng, 8).astype(np.float64)
    pred = gt.copy()
    pred[:, :3, 3] = 1.7 * pred[:, :3, 3] + rng.normal(scale=0.05, size=(8, 3))
    np.testing.assert_allclose(TE.camera_centers(pred), JE.camera_centers(pred), atol=1e-10)
    src, dst = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    for with_scale in (True, False):
        for a, b in zip(TE.umeyama_alignment(src, dst, with_scale),
                        JE.umeyama_alignment(src, dst, with_scale)):
            np.testing.assert_allclose(a, b, atol=1e-10)
    a, b = TE.absolute_trajectory_error(pred, gt), JE.absolute_trajectory_error(pred, gt)
    assert a.keys() == b.keys()
    for k in a:
        assert abs(a[k] - b[k]) <= 1e-10, k
    for fn in ("relative_rotation_angles_deg", "relative_translation_angles_deg"):
        np.testing.assert_allclose(getattr(TE, fn)(pred, gt), getattr(JE, fn)(pred, gt),
                                   atol=1e-10)
    errs = rng.uniform(0, 30, size=50)
    a, b = TE.pose_auc(errs), JE.pose_auc(errs)
    assert a.keys() == b.keys() and all(abs(a[k] - b[k]) <= 1e-10 for k in a)


# -- COLMAP I/O ------------------------------------------------------------------

_FILES = ("cameras.txt", "images.txt", "points3D.txt", "cameras.bin", "images.bin",
          "points3D.bin")


def _reconstruction(M, rng, S=3, P=12):
    """One reconstruction built from the same numpy arrays in package M."""
    rec = M.Reconstruction()
    for s in range(S):
        model = "SIMPLE_PINHOLE" if s == 0 else "PINHOLE"
        params = rng.uniform(50, 400, size=3 if s == 0 else 4)
        rec.cameras[s + 1] = M.Camera(s + 1, model, 640, 480, params)
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        rec.images[s + 1] = M.ImageRecord(s + 1, f"img_{s}.jpg", s + 1, q, rng.normal(size=3))
    rec.images[1].xys = rng.uniform(0, 640, size=(P, 2))
    rec.images[1].point3d_ids = np.arange(1, P + 1, dtype=np.int64)
    rec.images[2].xys = rng.uniform(0, 640, size=(2, 2))
    rec.images[2].point3d_ids = np.array([-1, 3], np.int64)
    for p in range(P):
        rec.points3d[p + 1] = M.Point3D(p + 1, rng.normal(size=3),
                                        rng.integers(0, 256, size=3), float(rng.uniform()),
                                        [(1, p)] + ([(2, 1)] if p == 2 else []))
    return rec


def _same_models(dir_a, dir_b):
    for f in _FILES:
        assert filecmp.cmp(dir_a / f, dir_b / f, shallow=False), f


def test_colmap_files_byte_equal_and_read_across(tmp_path):
    j = _reconstruction(JC, np.random.default_rng(3))
    t = _reconstruction(TC, np.random.default_rng(3))
    for rec, d in ((j, tmp_path / "jax"), (t, tmp_path / "port")):
        rec.write_text(str(d))
        rec.write_binary(str(d))
    _same_models(tmp_path / "jax", tmp_path / "port")
    # each package reads the other's files, text and binary, and writes them
    # back byte for byte
    for reader, src, out in ((TC.Reconstruction, "jax", "port_again"),
                             (JC.Reconstruction, "port", "jax_again")):
        for read in (reader.read_text, reader.read_binary):
            back = read(str(tmp_path / src))
            back.write_binary(str(tmp_path / out))
            back.write_text(str(tmp_path / out))
        for f in _FILES[3:]:
            assert filecmp.cmp(tmp_path / src / f, tmp_path / out / f, shallow=False), f
    back = TC.Reconstruction.read_binary(str(tmp_path / "jax"))
    for i in j.images:
        np.testing.assert_array_equal(back.images[i].xys, j.images[i].xys)
        np.testing.assert_array_equal(back.images[i].point3d_ids, j.images[i].point3d_ids)
        np.testing.assert_allclose(back.images[i].w2c, j.images[i].w2c, atol=1e-6)
    assert all(back.points3d[p].track == j.points3d[p].track for p in j.points3d)


def _tracks_scene(rng, S=4, P=60):
    E = _poses(rng, S)
    E[:, :3, :3] = np.eye(3, dtype=np.float32) + 0.05 * (E[:, :3, :3] - np.eye(3))
    E[:, :3, :3] = np.asarray(JG.quat_to_mat(JG.mat_to_quat(jnp.asarray(E[:, :3, :3]))))
    E[:, :, 3] = rng.normal(scale=0.2, size=(S, 3))
    K = np.tile(np.array([[200.0, 0, 80], [0, 200.0, 60], [0, 0, 1]], np.float32), (S, 1, 1))
    X = rng.uniform(-1, 1, size=(P, 3)).astype(np.float32)
    X[:, 2] += 5.0
    cam = np.einsum("sij,nj->sni", E[:, :, :3], X) + E[:, None, :, 3]
    pix = np.einsum("ij,snj->sni", K[0], cam)
    tracks = (pix[..., :2] / pix[..., 2:]).astype(np.float32)
    tracks += rng.normal(scale=3.0, size=tracks.shape).astype(np.float32)
    masks = rng.uniform(size=(S, P)) > 0.2
    return X, tracks, masks, E, K


def test_batch_matrix_round_trip_matches_jax(rng, tmp_path):
    X, tracks, masks, E, K = _tracks_scene(rng)
    kw = dict(image_size=(160, 120), max_reproj_error=6.0, min_inlier_per_frame=8)
    j, jv = JC.batch_matrix_to_reconstruction(X, None, tracks, masks, E, K, **kw)
    t, tv = TC.batch_matrix_to_reconstruction(X, None, tracks, masks, E, K, **kw)
    np.testing.assert_array_equal(tv, jv)
    assert 0 < len(t.points3d) < X.shape[0]  # the gating removed some, kept some
    j.write_text(str(tmp_path / "jax"))
    j.write_binary(str(tmp_path / "jax"))
    t.write_text(str(tmp_path / "port"))
    t.write_binary(str(tmp_path / "port"))
    _same_models(tmp_path / "jax", tmp_path / "port")
    for a, b in zip(TC.reconstruction_to_batch_matrix(t), JC.reconstruction_to_batch_matrix(j)):
        np.testing.assert_allclose(a, b, atol=1e-6)
    # nothing survives an impossible gate
    none, _ = TC.batch_matrix_to_reconstruction(X, None, tracks + 1e3, masks, E, K, **kw)
    assert none is None


# -- images and plots -------------------------------------------------------------------


def test_images_match_jax(rng, tmp_path):
    from PIL import Image

    from self_supervise_sfm_tpu.utils import images as JI
    from self_supervise_sfm_tpu_torch.utils import images as TI

    paths = []
    for i, (w, h, mode) in enumerate(((40, 30, "RGB"), (24, 36, "RGBA"))):
        arr = rng.integers(0, 256, size=(h, w, len(mode)), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(arr, mode).save(paths[-1])
    for a, b in zip(TI.load_and_preprocess_images_square(paths, 28),
                    JI.load_and_preprocess_images_square(paths, 28)):
        np.testing.assert_array_equal(a, b)
    mask = rng.uniform(size=(6, 7)) > 0.3
    np.testing.assert_array_equal(
        TI.randomly_limit_trues(mask, 9, np.random.default_rng(1)),
        JI.randomly_limit_trues(mask, 9, np.random.default_rng(1)))
    for a, b in zip(TI.create_pixel_coordinate_grid(2, 3, 4),
                    JI.create_pixel_coordinate_grid(2, 3, 4)):
        np.testing.assert_array_equal(a, b)


def test_depth_and_track_plots_match_jax(rng, tmp_path):
    from PIL import Image

    from self_supervise_sfm_tpu.utils import vls as JV
    from self_supervise_sfm_tpu_torch.utils import vls as TV

    depth = rng.uniform(0.5, 4.0, size=(12, 16)).astype(np.float32)
    depth[0, :3] = [0.0, np.nan, -1.0]
    np.testing.assert_array_equal(TV.colorize_depth(depth), JV.colorize_depth(depth))
    images = rng.uniform(size=(2, 24, 32, 3)).astype(np.float32)
    tracks = rng.uniform(0, 24, size=(2, 10, 2)).astype(np.float32)
    vis = rng.uniform(size=(2, 10)) > 0.3
    a = TV.visualize_tracks_on_images(images, tracks, vis, str(tmp_path / "port"))
    b = JV.visualize_tracks_on_images(images, tracks, vis, str(tmp_path / "jax"))
    assert [p.split("/")[-1] for p in a] == [p.split("/")[-1] for p in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(Image.open(x)), np.asarray(Image.open(y)))
