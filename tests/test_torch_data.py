"""PyTorch port, trainer slice: the data plane, geometry diagnostics and
exports against the JAX package.

Synthetic IMC2021-format scenes (``make_synthetic_dataset``, 40 x 32 px)
read by both packages: ``load_scene`` bit-equal with the Python loader and
with the native loader (the port's own ctypes binding, built into
``build/``), ``scene_stream`` batches bit-equal for one seed, the port's
synthetic writer equal to the JAX one, preprocessing bit-equal;
``resample_pos_embed`` and ``scene_cdf_statistics`` atol 1e-6 (fp32
arithmetic in another order); ``sanity_check_relative_poses`` atol 1e-4 px;
PLY and KITTI files byte-equal; ``BestTracker`` decisions equal; the
plots written.
"""

import io
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from self_supervise_sfm_tpu.data import imc2021 as JD
from self_supervise_sfm_tpu.data import preprocess as JP
from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset
from self_supervise_sfm_tpu.layers.vit import resample_pos_embed as j_resample
from self_supervise_sfm_tpu.native import dataplane as JDP
from self_supervise_sfm_tpu.train import loss as JLS
from self_supervise_sfm_tpu.train import trainer as JT
from self_supervise_sfm_tpu.train.validate import BestTracker as JBest
from self_supervise_sfm_tpu.utils import export as JEX
from self_supervise_sfm_tpu.utils.sanity_check import sanity_check_relative_poses as j_sanity
from self_supervise_sfm_tpu_torch.data import imc2021 as TD
from self_supervise_sfm_tpu_torch.data import preprocess as TP
from self_supervise_sfm_tpu_torch.data import synthetic as TS
from self_supervise_sfm_tpu_torch.layers.vit import resample_pos_embed as t_resample
from self_supervise_sfm_tpu_torch.native import dataplane as TDP
from self_supervise_sfm_tpu_torch.train import loss as TLS
from self_supervise_sfm_tpu_torch.train import trainer as TT
from self_supervise_sfm_tpu_torch.train.validate import BestTracker as TBest
from self_supervise_sfm_tpu_torch.utils import export as TEX
from self_supervise_sfm_tpu_torch.utils import vls as TV
from self_supervise_sfm_tpu_torch.utils.sanity_check import (
    sanity_check_relative_poses as t_sanity)

torch.set_num_threads(1)

IMG = 28
KEYS = ("images", "depth_processed", "K_to_K_prime", "K_prime_to_K", "K_gt",
        "poses_w2c_gt", "src_idx", "dst_idx", "src_coords", "dst_coords",
        "src_depth", "dst_depth", "pair_valid")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_synthetic_dataset(str(tmp_path_factory.mktemp("scenes")), num_scenes=2,
                                  num_images=3, image_size=(40, 32))


def _scene_equal(a, b):
    assert a["scene_name"] == b["scene_name"]
    assert list(a["image_names"]) == list(b["image_names"])
    assert a["shared_focal"] == b["shared_focal"]
    for k in KEYS:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("idx", [0, 1])
def test_load_scene_python_loader_bit_equal(root, idx):
    kw = dict(sample_num=96, num_images=2, target_size=IMG, use_native=False)
    a = JD.IMC2021Scenes(root, **kw).load_scene(idx, np.random.default_rng(idx + 5))
    b = TD.IMC2021Scenes(root, **kw).load_scene(idx, np.random.default_rng(idx + 5))
    _scene_equal(a, b)


def test_load_scene_native_loader_bit_equal(root):
    """The port's binding (built into ``build/dataplane``) and the JAX
    package's read the same C++ source: the same scene, bit for bit."""
    if not (TDP.available() and JDP.available()):
        pytest.skip("the native data plane does not build here (g++ with libjpeg/libpng)")
    assert TDP._LIB.startswith(os.path.join(TDP._ROOT, "build") + os.sep)
    kw = dict(sample_num=96, num_images=3, target_size=IMG, use_native=True)
    tds = TD.IMC2021Scenes(root, **kw)
    assert tds.use_native
    for idx in range(2):
        a = JD.IMC2021Scenes(root, **kw).load_scene(idx, np.random.default_rng(idx))
        _scene_equal(a, tds.load_scene(idx, np.random.default_rng(idx)))


def test_native_auto_follows_availability(root):
    ds = TD.IMC2021Scenes(root, sample_num=8, num_images=2, target_size=IMG,
                          use_native=None)
    assert ds.use_native == TDP.available()


def test_scene_stream_batches_bit_equal(root):
    kw = dict(sample_num=64, num_images=2, target_size=IMG, use_native=False)
    jds, tds = JD.IMC2021Scenes(root, **kw), TD.IMC2021Scenes(root, **kw)
    ja = JT.scene_stream(jds, range(3), seed=7, prefetch=2)
    ta = TT.scene_stream(tds, range(3), seed=7, prefetch=2)
    try:
        for _ in range(3):
            a, b = next(ja), next(ta)
            assert a["scene_name"] == b["scene_name"]
            for k in KEYS:
                assert np.array_equal(a[k], b[k]), k
    finally:
        ja.close()
        ta.close()


def test_scene_stream_raises_the_loaders_error():
    class Broken:
        def __len__(self):
            return 1

        def load_scene(self, idx, rng):
            raise OSError("unreadable scene")

    stream = TT.scene_stream(Broken(), range(1), seed=0, prefetch=1)
    with pytest.raises(RuntimeError, match="scene loader") as info:
        next(stream)
    assert isinstance(info.value.__cause__, OSError)


def test_synthetic_writer_matches_jax(tmp_path):
    """The port's copy of the fixture writer writes the same HDF5 contents,
    dataset by dataset."""
    paths = []
    for name, mod in (("jax", None), ("port", TS)):
        d = str(tmp_path / name / "scene")
        if mod is None:
            from self_supervise_sfm_tpu.data.synthetic import make_synthetic_scene
        else:
            make_synthetic_scene = mod.make_synthetic_scene
        paths.append(make_synthetic_scene(d, num_images=3, image_size=(40, 32), seed=3,
                                          geometry="corner_rand"))
    with h5py.File(paths[0], "r") as fa, h5py.File(paths[1], "r") as fb:
        names = []
        fa.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
        other = []
        fb.visititems(lambda n, o: other.append(n) if isinstance(o, h5py.Dataset) else None)
        assert names == other and len(names) > 0
        for n in names:
            assert np.array_equal(np.asarray(fa[n]), np.asarray(fb[n])), n


@pytest.mark.parametrize("size", [(40, 32), (31, 47), (24, 24)])
def test_preprocess_bit_equal(size):
    rng = np.random.default_rng(sum(size))
    rgb = Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8))
    dep = Image.fromarray(rng.integers(0, 9000, (size[1], size[0]), np.uint16))
    for img, is_depth in ((rgb, False), (dep, True)):
        a, b = JP.preprocess_image(img, IMG, is_depth), TP.preprocess_image(img, IMG, is_depth)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    n = size[0] * size[1]
    cs, cd = rng.uniform(-1, 1, (n, 2)), rng.uniform(-1, 1, (n, 2))
    cert = rng.uniform(0, 1, n).astype(np.float32)
    depth = rng.uniform(1, 5, (size[1], size[0])).astype(np.float32)
    a = JP.sample_correspondence_and_depth(cs, cd, cert, depth, depth, 50, 0.2,
                                           np.random.default_rng(1))
    b = TP.sample_correspondence_and_depth(cs, cd, cert, depth, depth, 50, 0.2,
                                           np.random.default_rng(1))
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("grid", [2, 3, 4, 6])
def test_resample_pos_embed_matches_jax(grid):
    pe = np.random.default_rng(grid).normal(size=(1, 1 + 16, 8)).astype(np.float32)
    ref = np.asarray(j_resample(jnp.asarray(pe), grid))
    got = t_resample(torch.from_numpy(pe), grid).numpy()
    assert got.shape == ref.shape == (1, 1 + grid * grid, 8)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="square"):
        t_resample(torch.zeros(1, 1 + 15, 8), grid)


def _poses(scene, rng, noise):
    """The scene's ground-truth poses and processed-space intrinsics,
    perturbed."""
    ext = scene["poses_w2c_gt"][:, :3].astype(np.float32)
    ext = ext + noise * rng.normal(size=ext.shape).astype(np.float32)
    intr = (scene["K_to_K_prime"] @ scene["K_gt"]).astype(np.float32)
    intr = intr * (1 + noise * rng.normal(size=intr.shape)).astype(np.float32)
    intr[:, 2] = [0, 0, 1]
    return ext, intr


@pytest.fixture(scope="module")
def scene(root):
    ds = TD.IMC2021Scenes(root, sample_num=128, num_images=3, target_size=IMG,
                          use_native=False)
    return ds.load_scene(0, np.random.default_rng(0))


@pytest.mark.parametrize("noise", [0.0, 0.01, 0.05])
def test_scene_cdf_statistics_matches_jax(scene, noise):
    from self_supervise_sfm_tpu.train.loss import LossConfig as JC
    from self_supervise_sfm_tpu_torch.train.loss import LossConfig as TC

    ext, intr = _poses(scene, np.random.default_rng(3), noise)
    keys = ("K_prime_to_K", "src_idx", "dst_idx", "src_coords", "dst_coords", "src_depth",
            "dst_depth", "pair_valid")
    ref = jax.jit(JLS.scene_cdf_statistics, static_argnums=3)(
        jnp.asarray(ext), jnp.asarray(intr), {k: jnp.asarray(scene[k]) for k in keys},
        JC(num_bins=50, max_val=4.0))
    got = TLS.scene_cdf_statistics(
        torch.from_numpy(ext), torch.from_numpy(intr),
        {k: torch.from_numpy(scene[k]) for k in keys}, TC(num_bins=50, max_val=4.0))
    for kind in ("exact", "approx"):
        for k in ("frame_pmf", "frame_cdf", "frame_pdf"):
            r = np.asarray(ref[kind][k])
            assert got[kind][k].shape == r.shape == (3, 50)
            np.testing.assert_allclose(got[kind][k].numpy(), r, rtol=0, atol=1e-6,
                                       err_msg=f"{kind}/{k}")
    assert float(got["exact"]["frame_pmf"].sum()) > 0


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_sanity_check_matches_jax(scene, noise):
    ext, intr = _poses(scene, np.random.default_rng(4), noise)
    valid = np.flatnonzero(scene["pair_valid"] > 0)
    for pair in valid:
        a = j_sanity(ext, intr, scene, pair=int(pair))
        b = t_sanity(ext, intr, scene, pair=int(pair))
        assert a["pair"] == b["pair"] == pair
        for k in ("mean_px_offset", "median_px_offset"):
            assert b[k] == pytest.approx(a[k], abs=1e-4), k
    # a random pair is drawn from the rng as the JAX function draws it
    a = j_sanity(ext, intr, scene, rng=np.random.default_rng(9))
    b = t_sanity(ext, intr, scene, rng=np.random.default_rng(9))
    assert a["pair"] == b["pair"]
    if noise == 0.0:  # ground truth reprojects its correspondences
        assert b["mean_px_offset"] < 0.5


def test_sanity_check_without_valid_pairs(scene):
    empty = {**scene, "pair_valid": np.zeros_like(scene["pair_valid"])}
    ext, intr = _poses(scene, np.random.default_rng(0), 0.0)
    m = t_sanity(ext, intr, empty)
    assert m["pair"] == -1 and np.isnan(m["mean_px_offset"])


@pytest.mark.parametrize("colors", ["none", "unit", "uint8"])
def test_ply_byte_equal(tmp_path, colors):
    rng = np.random.default_rng(0)
    preds = []
    for _ in range(2):
        p = {"point_map": rng.normal(size=(6, 5, 3)).astype(np.float32),
             "xyz_cnf": rng.uniform(0, 3, (6, 5)).astype(np.float32)}
        if colors == "unit":
            p["images"] = rng.uniform(size=(6, 5, 3)).astype(np.float32)
        elif colors == "uint8":
            p["rgbs"] = rng.integers(0, 256, (6, 5, 3), np.uint8)
        preds.append(p)
    a, b = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
    JEX.save_pointcloud_ply(preds, a)
    TEX.save_pointcloud_ply(preds, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    pts, _ = TEX.read_ply(b)
    assert pts.shape[1] == 3 and len(pts) > 0


def test_kitti_byte_equal(tmp_path, scene):
    ext = scene["poses_w2c_gt"][:, :3]
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    JEX.save_kitti_poses(ext, a)
    TEX.save_kitti_poses(ext, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    np.testing.assert_allclose(TEX.load_kitti_poses(b),
                               np.linalg.inv(scene["poses_w2c_gt"])[:, :3], atol=1e-6)
    assert TEX.uniform_sample(list(range(10)), 4) == JEX.uniform_sample(list(range(10)), 4)
    tree = TEX.to_cpu({"a": torch.ones(2), "b": [np.zeros(1)]})
    assert isinstance(tree["a"], np.ndarray) and isinstance(tree["b"][0], np.ndarray)


@pytest.mark.parametrize("patience,min_delta", [(0, 0.0), (2, 0.0), (1, 0.1), (3, 2.0)])
def test_best_tracker_decisions_equal(patience, min_delta):
    metrics = [5.0, 4.0, 4.1, 3.9, 3.95, 3.5, 3.6, 3.7, 3.8, 1.0]
    a, b = JBest(patience, min_delta), TBest(patience, min_delta)
    for step, m in enumerate(metrics):
        assert a.update(step, m) == b.update(step, m)
        assert (a.best, a.best_step, a.stale) == (b.best, b.best_step, b.stale)
    assert a.summary() == b.summary()


def test_plots_are_written(tmp_path, scene):
    ext, intr = _poses(scene, np.random.default_rng(5), 0.01)
    cdf = np.cumsum(np.full((3, 20), 0.05), axis=1)
    paths = [
        TV.plot_cdf_pdf_curves(cdf, np.gradient(cdf, axis=1), 0.0, 4.0, 20,
                               str(tmp_path / "cdf.png")),
        TV.reprojection_validation_grid(scene, ext, intr, save_path=str(tmp_path / "g.png")),
        t_sanity(ext, intr, scene, pair=0, save_path=str(tmp_path / "o.png")) and
        str(tmp_path / "o.png"),
    ]
    for p in paths:
        assert os.path.getsize(p) > 1000
        assert Image.open(io.BytesIO(open(p, "rb").read())).format == "PNG"
