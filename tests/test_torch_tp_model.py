"""PyTorch port: the tiny model under tensor parallelism over gloo ranks vs the
JAX package's single-device programs.

The joint forward, ``build_scene_cache``, ``reloc`` and ``fast_reloc`` of
``tests/test_torch_scene_sharded.py``'s tiny model (28 px, embed 64, 4
heads, depth 4, rank 2) run on gloo ranks (``tests/_torch_dist_worker.py``,
one launch for the module) at (data, context, model) = (1, 1, 2) and
(2, 1, 2): every block (the ViT's, frame, reloc, global) on Megatron's
body, the cache cut over heads (each model rank builds its heads' rows from
its head shard of the reloc block's qkv), reloc against the head-cut cache
and against a whole cache (JAX's one-device build, cut by heads and scenes
in reloc). Held to JAX's single-device ``forward`` at
``tests/test_torch_model.py``'s fp32 tolerance, and to JAX's build and
reloc at ``tests/test_torch_scene_sharded.py``'s tolerances (cam tokens
and the joined cache 2e-4, the reloc predictions 5e-4 with the port's fp32
rtol 2e-4). Weights come from
JAX's ``init_sailrecon`` through ``convert.from_jax_params``; subsample
indices are explicit.
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
TINY = dict(img_size=IMG, embed_dim=64, depth=DEPTH, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3))
# name -> (data, context, model), scenes, anchors, queries
SERVE = {"serve_1x1x2": ((1, 1, 2), 1, 4, 3), "serve_2x1x2": ((2, 1, 2), 2, 4, 2)}
# name -> (data, context, model), scenes, anchors (= queries, duplicated)
FORWARD = {"fwd_1x1x2": ((1, 1, 2), 1, 4), "fwd_2x1x2": ((2, 1, 2), 2, 4)}
PRED_KEYS = ("extrinsic", "intrinsic", "depth_map", "point_map")
FAST_KEYS = ("extrinsic", "intrinsic")
FWD_KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
            "point_map_by_unprojection", "cam_tokens")
FP32_TOL = dict(rtol=2e-4, atol=1e-4)
RELOC_TOL = dict(rtol=2e-4, atol=5e-4)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _indices(rng, B, A):
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(DEPTH * B * A)])
    return idx.reshape(DEPTH, B, A, RANK).astype(np.int32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_model")
    rng = np.random.default_rng(0)
    cfg = JM.make_config(**TINY)
    jp = jax.jit(lambda k: JM.init_sailrecon(k, cfg))(jax.random.PRNGKey(0))
    save_tree(tmp / "tiny_params.npz", convert.from_jax_params(jax.tree.map(np.asarray, jp)))
    build = jax.jit(lambda p, x, i: JM.build_scene_cache(p, cfg, x, rank=RANK,
                                                         subsample_indices=i))
    reloc = jax.jit(lambda p, c, t, x: JM.reloc(p, cfg, c, t, x))
    fast = jax.jit(lambda p, c, t, x: JM.reloc(p, cfg, c, t, x, fast_reloc=True))
    cases, refs = [], {}
    for name, (mesh, B, A, Q) in SERVE.items():
        inp = dict(anchors=rng.uniform(size=(B, A, IMG, IMG, 3)).astype(np.float32),
                   queries=rng.uniform(size=(B, Q, IMG, IMG, 3)).astype(np.float32),
                   idx=_indices(rng, B, A))
        cache, cam = build(jp, jnp.asarray(inp["anchors"]), jnp.asarray(inp["idx"]))
        inp.update(kv_whole=np.asarray(cache["kv"]), cam_whole=np.asarray(cam))
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind="tp_scene", mesh=list(mesh), params="tiny_params",
                          config=TINY, rank=RANK))
        refs[name] = dict(kv=np.asarray(cache["kv"]), cam=np.asarray(cam),
                          preds=_np(reloc(jp, cache, cam, jnp.asarray(inp["queries"]))),
                          fast=_np(fast(jp, cache, cam, jnp.asarray(inp["queries"]))))
    for name, (mesh, B, A) in FORWARD.items():
        uniq = rng.uniform(size=(B, A, IMG, IMG, 3)).astype(np.float32)
        inp = dict(images=np.concatenate([uniq, uniq], axis=1), idx=_indices(rng, B, A))
        save_tree(tmp / f"{name}.in.npz", inp)
        cases.append(dict(name=name, kind="forward", mesh=list(mesh), params="tiny_params",
                          config=TINY, rank=RANK, A=A, Q=A, duplicated=True))
        fwd = jax.jit(lambda p, x, i, A=A: JM.forward(p, cfg, x, A, A, rank=RANK,
                                                      subsample_indices=i,
                                                      images_duplicated=True))
        refs[name] = _np(fwd(jp, jnp.asarray(inp["images"]), jnp.asarray(inp["idx"])))
    launch(dict(cases=cases), WORLD, tmp)
    got = {}
    for case in cases:
        n = int(np.prod(case["mesh"]))
        got[case["name"]] = [load_tree(tmp / f"{case['name']}.r{r}.npz") for r in range(n)]
    return got, refs


def _joined_cache(results, nd, nm):
    """The ranks' caches joined: model ranks' heads along the head axis,
    data ranks' scenes along the scene axis (rank = d * nm + m)."""
    rows = [np.concatenate([results[d * nm + m]["kv"].numpy() for m in range(nm)], axis=2)
            for d in range(nd)]
    return np.concatenate(rows, axis=1)


@pytest.mark.parametrize("name", list(SERVE))
def test_cam_tokens_and_head_cut_cache_match_jax(ranks, name):
    got, refs = ranks
    (nd, nc, nm), B, A, _ = SERVE[name]
    whole = refs[name]["kv"]
    D, _, H, N, d2 = whole.shape
    for res in got[name]:
        np.testing.assert_allclose(res["cam"].numpy(), refs[name]["cam"], atol=2e-4)
        assert tuple(res["shards"].numpy()) == (nd, nc, nm)
        # each rank holds its scenes' rows of its heads alone
        assert tuple(res["kv"].shape) == (D, B // nd, H // nm, N, d2)
    np.testing.assert_allclose(_joined_cache(got[name], nd, nm), whole, atol=2e-4)


def _reloc_cases():
    for name in SERVE:
        for which, keys in (("preds", PRED_KEYS), ("fast", FAST_KEYS), ("whole", PRED_KEYS)):
            for k in keys:
                yield name, which, k


@pytest.mark.parametrize("name,which,key", list(_reloc_cases()))
def test_reloc_matches_jax_single_device(ranks, name, which, key):
    """Reloc against the head-cut cache (full heads and ``fast_reloc``) and
    against the whole one-device cache, cut by heads in reloc."""
    got, refs = ranks
    ref = refs[name]["fast" if which == "fast" else "preds"][key]
    for r, res in enumerate(got[name]):
        np.testing.assert_allclose(res[which][key].numpy(), ref, err_msg=f"rank {r}",
                                   **RELOC_TOL)


@pytest.mark.parametrize("name", list(FORWARD))
@pytest.mark.parametrize("key", FWD_KEYS + ("pose_enc_list",))
def test_tp_forward_matches_jax(ranks, name, key):
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
