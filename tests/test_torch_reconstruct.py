"""PyTorch port: track prediction, triangulation, the track-to-reconstruction
hand-off and the reconstruction demo against the JAX package.

- ``predict_tracks`` (query reordering, chunking, augmentation) is bit-equal
  to the port's own per-chunk tracker calls, as ``tests/test_pipeline.py``
  checks the JAX package's, and within 1e-4 px of the JAX package's on identical
  weights (drawn in the port, carried to JAX by the inverse of
  ``convert.tracker_from_jax``), both run at one coarse and one fine
  iteration (``tests/test_torch_tracker.py`` says why).
- ``triangulate_tracks`` (one batched SVD here, a loop of SVDs in JAX)
  within 1e-5 relative; tracks seen in fewer than two frames stay at 0.
- ``tracks_to_reconstruction`` with each engine against the JAX package's
  (the torch engine against the JAX solver, 1e-3; the native engine
  against the JAX binding, 1e-6) on ``make_ba_scene``'s geometry.
- The demo's ``run()`` in both modes with ``--tracks-ba`` against the JAX
  demo's ``main`` on one synthetic HDF5 scene, the JAX weights converted,
  at full rank (every token kept, so no subsample draw differs). Both
  demos take the port's tracks (the JAX tracker recompiles for every query
  count, and the trackers are held against each other above): results,
  KITTI poses and COLMAP models within 1e-4.
"""

import json
import os
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.pipeline import tracking as JT
from self_supervise_sfm_tpu.pipeline import vggsfm_tracker as JV
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.pipeline import tracking as TT
from self_supervise_sfm_tpu_torch.pipeline import vggsfm_tracker as TV
from tests.test_bundle_adjust import make_ba_scene
from tests.test_torch_tracker import small_cfg

torch.set_num_threads(1)


def _to_jax(node, key=None):
    """The port's tracker params as the JAX package's (conv weights OIHW ->
    HWIO): the inverse of ``convert.tracker_from_jax``, which
    ``tests/test_torch_tracker.py`` uses; drawing them in the port spares
    this module JAX's init."""
    if isinstance(node, dict):
        return {k: _to_jax(v, k) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_jax(v, key) for v in node]
    a = node.numpy()
    return jnp.asarray(a.transpose(2, 3, 1, 0) if key == "w" and a.ndim == 4 else a)


@pytest.fixture(scope="module")
def tracker():
    tcfg = small_cfg(TV, fine_iters=1)
    tp = TV.init_vggsfm_tracker(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jp = _to_jax(tp)
    back = convert.tracker_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(back),
                                                 jax.tree_util.tree_leaves(tp)))
    return jp, tp, small_cfg(JV, fine_iters=1), tcfg


@pytest.fixture
def one_coarse_iteration(monkeypatch):
    """Both packages' ``track`` at one coarse iteration; the JAX one jitted
    (``cfg`` static)."""
    jtrack = jax.jit(partial(JV.track, coarse_iters=1),
                     static_argnames=("cfg", "fine_tracking"))
    monkeypatch.setattr(JV, "track", lambda p, i, q, cfg, fine_tracking=True: jtrack(
        p, i, q, cfg=cfg, fine_tracking=fine_tracking))
    monkeypatch.setattr(TV, "track", partial(TV.track, coarse_iters=1))


@pytest.mark.parametrize("fine", [False, True])
def test_predict_tracks_matches_own_chunks_and_jax(rng, tracker, one_coarse_iteration, fine):
    jp, tp, jcfg, tcfg = tracker
    S = 3
    images = rng.uniform(size=(S, 64, 64, 3)).astype(np.float32)
    kw = dict(query_frame_indexes=[1], max_query_pts=20, max_points_per_chunk=7,
              fine_tracking=fine, augment_min_vis_frac=-1.0)
    tracks, vis, qpts = TT.predict_tracks(tp, images, tracker_cfg=tcfg, device="cpu", **kw)
    # by hand: frame 1 leads, 7-point chunks, back to the original order
    from self_supervise_sfm_tpu_torch.pipeline.extractors import (
        extract_keypoints_union, initialize_feature_extractors)

    xy = extract_keypoints_union(images[1], initialize_feature_extractors(
        "shi_tomasi", max_pts=20, device="cpu"))[:20]
    order = [1, 0, 2]
    imgs = torch.from_numpy(images[order])[None]
    trs, vs = [], []
    for lo in range(0, len(xy), 7):
        f, _, v = TV.track(tp, imgs, torch.from_numpy(xy[lo:lo + 7])[None], tcfg,
                           fine_tracking=fine, device="cpu")
        trs.append(f[0].numpy())
        vs.append(v[0].numpy())
    inv = np.argsort(order)
    np.testing.assert_array_equal(qpts, xy)
    np.testing.assert_array_equal(tracks, np.concatenate(trs, axis=1)[inv])
    np.testing.assert_array_equal(vis, np.concatenate(vs, axis=1)[inv])
    np.testing.assert_allclose(tracks[1], qpts, atol=1e-3)
    # the JAX package's predict_tracks on the same weights
    jt, jvis, jq = JT.predict_tracks(jp, images, tracker_cfg=jcfg, **kw)
    np.testing.assert_array_equal(qpts, jq)
    np.testing.assert_allclose(tracks, jt, atol=1e-4)
    np.testing.assert_allclose(vis, jvis, atol=1e-5)


def test_predict_tracks_augmentation_matches_jax(rng, tracker, one_coarse_iteration):
    jp, tp, jcfg, tcfg = tracker
    images = rng.uniform(size=(3, 64, 64, 3)).astype(np.float32)
    kw = dict(query_frame_indexes=[0], max_query_pts=16, max_points_per_chunk=64,
              fine_tracking=False, augment_min_vis_frac=2.0, max_augment_frames=1)
    t, v, q = TT.predict_tracks(tp, images, tracker_cfg=tcfg, device="cpu", **kw)
    jt, jv, jq = JT.predict_tracks(jp, images, tracker_cfg=jcfg, **kw)
    base = TT.predict_tracks(tp, images, tracker_cfg=tcfg, device="cpu",
                             **{**kw, "augment_min_vis_frac": -1.0})
    assert t.shape[1] > base[0].shape[1]  # the augmentation added a query frame
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_allclose(t, jt, atol=1e-4)
    np.testing.assert_allclose(v, jv, atol=1e-5)


def _tracks_of(exts, Ks, pts, ci, pi, uv):
    S, N = exts.shape[0], pts.shape[0]
    tracks = np.zeros((S, N, 2), np.float32)
    vis = np.zeros((S, N), bool)
    for c, p, xy in zip(ci, pi, uv):
        tracks[c, p] = xy
        vis[c, p] = True
    return tracks, vis


def test_triangulation_matches_jax(rng):
    exts, Ks, pts, ci, pi, uv = make_ba_scene(rng, C=4, P=60, noise_px=0.5)
    tracks, vis = _tracks_of(exts, Ks, pts, ci, pi, uv)
    vis[1:, :5] = False  # seen once: stays at 0
    vis[2:, 5:10] = False  # seen twice: 4 rows, triangulated
    vis = vis.astype(np.float32)  # the float visibility of the tracker
    got = TT.triangulate_tracks(tracks, vis, exts, Ks)
    ref = JT.triangulate_tracks(tracks, vis, exts, Ks)
    assert (got[:5] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got).all() and (np.abs(got[5:]).sum(-1) > 0).all()


@pytest.mark.parametrize("engine", ["torch", "native"])
def test_tracks_to_reconstruction_matches_jax(rng, engine):
    from self_supervise_sfm_tpu.utils import colmap_io as JC
    from self_supervise_sfm_tpu_torch.utils import colmap_io as TC

    exts, Ks, pts, ci, pi, uv = make_ba_scene(rng, C=4, P=50, noise_px=0.5)
    tracks, vis = _tracks_of(exts, Ks, pts, ci, pi, uv)
    exts_n = exts.copy()
    exts_n[1:, :3, 3] += rng.normal(scale=0.01, size=(3, 3)).astype(np.float32)
    kw = dict(image_size=(256, 192))
    timings = {}
    rec = TT.tracks_to_reconstruction(tracks, vis, exts_n, Ks, ba_engine=engine,
                                      device="cpu", timings=timings, **kw)
    ref = JT.tracks_to_reconstruction(tracks, vis, exts_n, Ks,
                                      use_native_ba=engine == "native", **kw)
    assert set(timings) == {"triangulation", f"ba_{engine}"}
    assert sorted(rec.points3d) == sorted(ref.points3d)
    atol = 1e-3 if engine == "torch" else 1e-6
    for a, b in zip(TC.reconstruction_to_batch_matrix(rec), JC.reconstruction_to_batch_matrix(ref)):
        np.testing.assert_allclose(a, b, atol=atol)
    none = TT.tracks_to_reconstruction(tracks, vis, exts_n, Ks, run_ba=False, **kw)
    assert len(none.points3d) == len(rec.points3d)
    with pytest.raises(ValueError, match="ba_engine"):
        TT.tracks_to_reconstruction(tracks, vis, exts_n, Ks, ba_engine="jax", **kw)


def test_entry_points_default_to_cuda_and_raise_without_a_card(rng, tracker):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    _, tp, _, tcfg = tracker
    images = rng.uniform(size=(2, 32, 32, 3)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.predict_tracks(tp, images, tracker_cfg=tcfg)
    exts, Ks, pts, ci, pi, uv = make_ba_scene(rng, C=3, P=20)
    tracks, vis = _tracks_of(exts, Ks, pts, ci, pi, uv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.tracks_to_reconstruction(tracks, vis, exts, Ks, image_size=(256, 192))


# -- the demo -----------------------------------------------------------------------------

TINY = dict(img_size=28, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3), attn_impl="dense")


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from self_supervise_sfm_tpu.data.synthetic import make_synthetic_dataset

    root = str(tmp_path_factory.mktemp("scenes"))
    make_synthetic_dataset(root, num_scenes=1, num_images=3, image_size=(40, 32))
    return root


def _demo_argv(root, out, mode):
    return ["--data-root", root, "--out-dir", out, "--mode", mode, "--num-images", "3",
            "--img-size", "28", "--rank", "4", "--num-scenes", "1", "--compute-dtype",
            "float32", "--tracks-ba", "--max-query-pts", "16"]


@pytest.mark.parametrize("mode", ["forward", "reloc"])
def test_demo_matches_jax(scenes, tmp_path, monkeypatch, mode):
    from self_supervise_sfm_tpu.demos import reconstruct as JD
    from self_supervise_sfm_tpu.models import sailrecon as JM
    from self_supervise_sfm_tpu.utils import colmap_io as JC
    from self_supervise_sfm_tpu_torch.data.imc2021 import IMC2021Scenes
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.utils import colmap_io as TC
    from self_supervise_sfm_tpu_torch.utils.export import load_kitti_poses

    for M in (JM, TM):
        orig = M.make_config
        monkeypatch.setattr(M, "make_config", lambda _o=orig, **kw: _o(**{**kw, **TINY}))
    tcfg = small_cfg(TV, fine_iters=1)
    tp = TV.init_vggsfm_tracker(tcfg, torch.Generator().manual_seed(2), device="cpu")

    def port_tracks(_params, images, **kw):
        kw.update(tracker_cfg=tcfg, device="cpu")
        return TT.predict_tracks(tp, images, **kw)

    # the JAX demo: its own weights (PRNGKey(0)), forward / reloc, DLT, its
    # LM solver and its export; the port's tracks
    monkeypatch.setattr(JT, "predict_tracks", port_tracks)
    monkeypatch.setattr(JV, "init_vggsfm_tracker", lambda key, cfg: {})
    drawn = []
    init = JM.init_sailrecon
    monkeypatch.setattr(JM, "init_sailrecon", lambda *a: drawn.append(init(*a)) or drawn[-1])
    jout = str(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", ["demo"] + _demo_argv(scenes, jout, mode))
    JD.main()
    # the port's demo on the JAX demo's weights, converted
    jparams = jax.tree_util.tree_map(np.asarray, drawn[0])
    args = TD.parse_args(_demo_argv(scenes, str(tmp_path / "port"), mode) + ["--device", "cpu"])
    results = TD.run(args, IMC2021Scenes(scenes, sample_num=16, num_images=3, target_size=28),
                     params=convert.from_jax_params(jparams), tracker_params=tp,
                     tracker_cfg=tcfg)
    jres = json.load(open(os.path.join(jout, "results.json")))
    assert json.load(open(tmp_path / "port" / "results.json")) == json.loads(json.dumps(results))
    (name, entry), = results.items()
    jentry = jres[name]
    assert set(jentry) <= set(entry) and "stage_seconds" in entry
    for k in jentry:
        if k != "seconds":
            np.testing.assert_allclose(entry[k], jentry[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for f in ("poses_kitti.txt", "poses_kitti_ba.txt"):
        a, b = tmp_path / "port" / name / f, os.path.join(jout, name, f)
        assert a.exists() == os.path.exists(b), f
        if a.exists():
            np.testing.assert_allclose(load_kitti_poses(str(a)), load_kitti_poses(b),
                                       atol=1e-4)
    assert os.path.getsize(tmp_path / "port" / name / "pred.ply") > 0
    sparse = tmp_path / "port" / name / "sparse"
    assert sparse.exists() == ("ba_points" in entry) == os.path.exists(
        os.path.join(jout, name, "sparse"))
    if sparse.exists():
        a = TC.Reconstruction.read_binary(str(sparse))
        b = JC.Reconstruction.read_binary(os.path.join(jout, name, "sparse"))
        for x, y in zip(TC.reconstruction_to_batch_matrix(a),
                        JC.reconstruction_to_batch_matrix(b)):
            np.testing.assert_allclose(x, y, atol=1e-4)


def test_demo_refusals_and_default_device(scenes, tmp_path, monkeypatch):
    """``--pretrained`` and ``--tracker-weights`` refuse nothing: they read
    their files (a missing one raises FileNotFoundError; converted weights
    load and the run goes on; ``tests/test_torch_converter.py`` holds
    their outputs against JAX). The default ``cuda`` raises without a
    card."""
    from self_supervise_sfm_tpu.models import sailrecon as JM
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from tests.test_torch_converter import random_params, reference_state_dict

    orig = TM.make_config
    monkeypatch.setattr(TM, "make_config", lambda **kw: orig(**{**kw, **TINY}))
    jcfg, tcfg = small_cfg(JV), small_cfg(TV)
    monkeypatch.setattr(TV, "VGGSfMTrackerConfig", lambda: tcfg)
    files = {}
    for opt, init in (
            ("--pretrained", lambda: JM.init_sailrecon(jax.random.PRNGKey(0),
                                                       JM.make_config(**TINY))),
            ("--tracker-weights", lambda: JV.init_vggsfm_tracker(jax.random.PRNGKey(0), jcfg))):
        files[opt] = str(tmp_path / f"{opt[2:]}.pt")
        torch.save({k: torch.from_numpy(v) for k, v in
                    reference_state_dict(random_params(init)).items()}, files[opt])
    argv = _demo_argv(scenes, str(tmp_path), "forward") + ["--device", "cpu", "--depth", "4",
                                                           "--vit-depth", "2"]
    for opt in files:
        with pytest.raises(FileNotFoundError):
            TD.run(TD.parse_args(argv + [opt, str(tmp_path / "missing.pt")]), [])
    both = [x for opt, f in files.items() for x in (opt, f)]
    assert TD.run(TD.parse_args(argv + both), []) == {}
    if not torch.cuda.is_available():
        default = _demo_argv(scenes, str(tmp_path), "forward")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.main(default)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TD.run(TD.parse_args(default), [])


def test_demo_checkpoint_resamples_the_pos_embed(tmp_path):
    """``--checkpoint``: the port trainer's checkpoint directory, trained at
    28 px, served at 42 px."""
    from self_supervise_sfm_tpu_torch.demos import reconstruct as TD
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM
    from self_supervise_sfm_tpu_torch.train.checkpoint import CheckpointManager

    small = {k: v for k, v in TINY.items() if k != "img_size"}
    cfg28 = TM.make_config(img_size=28, **small)
    params = TM.init_sailrecon(cfg28, torch.Generator().manual_seed(0), device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, {"params": params, "step": 3})
    mgr.close()
    cfg42 = TM.make_config(img_size=42, **small)
    loaded = TD.load_params(cfg42, torch.Generator().manual_seed(1),
                            checkpoint=str(tmp_path / "ckpt"), device="cpu")
    assert loaded["aggregator"]["vit"]["pos_embed"].shape[1] == 1 + 3 * 3
    assert torch.equal(loaded["camera_head"]["trunk"][0]["attn"]["qkv"]["w"],
                       params["camera_head"]["trunk"][0]["attn"]["qkv"]["w"])
    with pytest.raises(FileNotFoundError):
        TD.load_params(cfg42, None, checkpoint=str(tmp_path / "none"), device="cpu")
