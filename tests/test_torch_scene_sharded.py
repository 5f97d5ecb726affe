"""PyTorch port: two-phase serving and the joint forward over gloo ranks vs
the JAX package's single-device programs.

JAX's 200-anchor, 8-query scene (``tests/test_scene_sharded.py``: 28 px,
embed 64, depth 4, rank 2, dense attention, the global site on the ring) is
built and relocalised by four gloo ranks on the CPU with the context-sharded
blocks (``tests/_torch_dist_worker.py``, one launch for the module): the cam
tokens and the gathered cache within 2e-4 and the reloc predictions within
5e-4 of JAX's single-device build and reloc (JAX's own tolerances), each
rank holding a quarter of the cache. The predictions also take the port's
fp32 rtol of 2e-4 (``tests/test_torch_serving.py``): the random-init heads'
exp / inverse-log activations reach 1e16 on this scene, where fp32 summation
order alone moves them by 7e-5 relative (the port's single-process reloc
differs from JAX's by as much). Two scenes over a 2 x 2 mesh exercise
the ``data`` axis: a cache cut over both axes, relocalised by cut queries and
by queries that do not divide (the layer gathered whole), and a whole cache
(anchors that do not divide) relocalised by cut queries. The joint forward
at 2 ranks, and at 2 x 2 with two scenes, is held to JAX's ``forward`` at
the tolerances of ``tests/test_torch_model.py``. Weights come from JAX's
``init_sailrecon`` through ``convert.from_jax_params``; subsample indices
are explicit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu_torch import convert
from tests._torch_dist_worker import launch, load_tree, save_tree

torch.set_num_threads(1)

WORLD = 4
IMG, RANK, DEPTH = 28, 2, 4
P0 = (IMG // 14) ** 2
SCENE = dict(img_size=IMG, embed_dim=64, depth=DEPTH, num_heads=4, vit_depth=2,
             intermediate_layer_idx=(0, 1, 2, 3), attn_impl="dense",
             global_attn_impl="ring")
TINY = dict(img_size=IMG, embed_dim=64, depth=DEPTH, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3))
# name -> (data, context), scenes, anchors, queries, queries of the second set
SERVE = {"scene200": ((1, 4), 1, 200, 8, None),
         "d2c2": ((2, 2), 2, 6, 4, 3),
         "whole_cache": ((2, 2), 2, 5, 4, None)}
# name -> (data, context), scenes, anchors (= queries, duplicated)
FORWARD = {"fwd_c2": ((1, 2), 1, 4), "fwd_d2c2": ((2, 2), 2, 4)}
PRED_KEYS = ("extrinsic", "intrinsic", "depth_map", "point_map")
FAST_KEYS = ("extrinsic", "intrinsic")
FWD_KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
            "point_map_by_unprojection", "cam_tokens")
# test_torch_model.py's fp32 tolerance
FP32_TOL = dict(rtol=2e-4, atol=1e-4)
# JAX's atol for the reloc predictions, with the port's fp32 rtol
RELOC_TOL = dict(rtol=2e-4, atol=5e-4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _indices(rng, B, A):
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(DEPTH * B * A)])
    return idx.reshape(DEPTH, B, A, RANK).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scene")
    rng = np.random.default_rng(0)
    cases, refs = [], {}
    for cfg_name, kw in (("scene_params", SCENE), ("tiny_params", TINY)):
        jp = jax.jit(lambda k, c=JM.make_config(**kw): JM.init_sailrecon(k, c))(
            jax.random.PRNGKey(0))
        refs[cfg_name] = jp
        save_tree(tmp / f"{cfg_name}.npz", convert.from_jax_params(jax.tree.map(np.asarray, jp)))

    cfg = JM.make_config(**SCENE)
    build = jax.jit(lambda p, x, i: JM.build_scene_cache(p, cfg, x, rank=RANK,
                                                         subsample_indices=i))
    reloc = jax.jit(lambda p, c, t, x: JM.reloc(p, cfg, c, t, x))
    fast = jax.jit(lambda p, c, t, x: JM.reloc(p, cfg, c, t, x, fast_reloc=True))
    for name, ((nd, nc), B, A, Q, Q2) in SERVE.items():
        inp = dict(anchors=rng.uniform(size=(B, A, IMG, IMG, 3)).astype(np.float32),
                   queries=rng.uniform(size=(B, Q, IMG, IMG, 3)).astype(np.float32),
                   idx=_indices(rng, B, A))
        if Q2:
            inp["queries2"] = rng.uniform(size=(B, Q2, IMG, IMG, 3)).astype(np.float32)
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind="scene", mesh=[nd, nc, 1], params="scene_params",
                          config=SCENE, rank=RANK))
        jp = refs["scene_params"]
        cache, cam = build(jp, jnp.asarray(inp["anchors"]), jnp.asarray(inp["idx"]))
        refs[name] = dict(kv=np.asarray(cache["kv"]), cam=np.asarray(cam),
                          preds=_np(reloc(jp, cache, cam, jnp.asarray(inp["queries"]))),
                          fast=_np(fast(jp, cache, cam, jnp.asarray(inp["queries"]))))
        if Q2:
            refs[name]["preds2"] = _np(reloc(jp, cache, cam, jnp.asarray(inp["queries2"])))

    tcfg = JM.make_config(**TINY)
    for name, ((nd, nc), B, A) in FORWARD.items():
        uniq = rng.uniform(size=(B, A, IMG, IMG, 3)).astype(np.float32)
        inp = dict(images=np.concatenate([uniq, uniq], axis=1), idx=_indices(rng, B, A))
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind="forward", mesh=[nd, nc, 1], params="tiny_params",
                          config=TINY, rank=RANK, A=A, Q=A, duplicated=True))
        fwd = jax.jit(lambda p, x, i, A=A: JM.forward(p, tcfg, x, A, A, rank=RANK,
                                                      subsample_indices=i,
                                                      images_duplicated=True))
        refs[name] = _np(fwd(refs["tiny_params"], jnp.asarray(inp["images"]),
                             jnp.asarray(inp["idx"])))
    launch(dict(cases=cases), WORLD, tmp)
    got = {}
    for case in cases:
        n = int(np.prod(case["mesh"]))
        got[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(n)]
    return got, refs


def _gathered_cache(results, nd, nc):
    """The ranks' caches joined: context rows along the token axis, data
    ranks along the scene axis (rank = d * nc + c)."""
    rows = [np.concatenate([results[d * nc + c]["kv"].numpy() for c in range(nc)], axis=3)
            for d in range(nd)]
    return np.concatenate(rows, axis=1)


@pytest.mark.parametrize("name", ["scene200", "d2c2"])
def test_cam_tokens_and_cache_match_jax(ranks, name):
    got, refs = ranks
    (nd, nc) = SERVE[name][0]
    for res in got[name]:
        np.testing.assert_allclose(res["cam"].numpy(), refs[name]["cam"], atol=2e-4)
        assert tuple(res["shards"].numpy()) == (nd, nc, 1)
    np.testing.assert_allclose(_gathered_cache(got[name], nd, nc), refs[name]["kv"], atol=2e-4)


@pytest.mark.parametrize("name", ["scene200", "d2c2"])
def test_each_rank_holds_its_share_of_the_cache(ranks, name):
    got, refs = ranks
    (nd, nc) = SERVE[name][0]
    whole = refs[name]["kv"]
    D, B, H, N, d2 = whole.shape
    for res in got[name]:
        assert tuple(res["kv"].shape) == (D, B // nd, H, N // nc, d2)
        assert int(res["kv_bytes"].item()) * nd * nc == whole.size * 4


def test_whole_cache_when_anchors_do_not_divide(ranks):
    """5 anchors over 2 context ranks: the build takes the replicated path,
    and every rank holds the whole cache."""
    got, refs = ranks
    for res in got["whole_cache"]:
        assert tuple(res["shards"].numpy()) == (0, 0)
        np.testing.assert_allclose(res["kv"].numpy(), refs["whole_cache"]["kv"], atol=2e-4)
        np.testing.assert_allclose(res["cam"].numpy(), refs["whole_cache"]["cam"], atol=2e-4)


def _reloc_cases():
    for name, spec in SERVE.items():
        for which, keys in (("preds", PRED_KEYS), ("fast", FAST_KEYS)):
            for k in keys:
                yield name, which, k
        if spec[4]:
            for k in PRED_KEYS:
                yield name, "preds2", k


@pytest.mark.parametrize("name,which,key", list(_reloc_cases()))
def test_reloc_matches_jax_single_device(ranks, name, which, key):
    got, refs = ranks
    for r, res in enumerate(got[name]):
        np.testing.assert_allclose(res[which][key].numpy(), refs[name][which][key],
                                   err_msg=f"rank {r}", **RELOC_TOL)


@pytest.mark.parametrize("name", list(SERVE))
def test_staged_and_chunked_refuse_a_mesh(ranks, name):
    got, _ = ranks
    for res in got[name]:
        assert res["refusals"].numpy().astype(bool).all()


@pytest.mark.parametrize("name", list(FORWARD))
@pytest.mark.parametrize("key", FWD_KEYS + ("pose_enc_list",))
def test_sharded_forward_matches_jax(ranks, name, key):
    got, refs = ranks
    ref = refs[name][key]
    for r, res in enumerate(got[name]):
        mine = res["preds"][key]
        pairs = zip(mine, ref) if key == "pose_enc_list" else [(mine, ref)]
        for a, b in pairs:
            a = a.numpy()
            fin = np.isfinite(b)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"rank {r}")
            np.testing.assert_allclose(a[fin], b[fin], err_msg=f"rank {r}", **FP32_TOL)
