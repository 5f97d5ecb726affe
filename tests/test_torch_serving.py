"""PyTorch port: two-phase serving (scene-cache build, reloc, the chunked and
host-staged variants, pose_forward) vs the JAX package.

The suite's tiny config, 6 anchors, 3 queries, rank 2, weights from the JAX
``init_sailrecon`` through ``convert.from_jax_params``, explicit subsample
indices. On the CPU the port's kernel wrappers run their plain versions.
Caches pass between the two packages in both directions.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import block as JB
from self_supervise_sfm_tpu.models import aggregator as JA
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.models import aggregator as TA
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import geometry as TG

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(img_size=28, embed_dim=64, depth=4, num_heads=4, vit_depth=2,
            intermediate_layer_idx=(0, 1, 2, 3))
A, Q, RANK = 6, 3, 2
KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
        "point_map_by_unprojection", "cam_tokens", "xyz_conf_fractions")
FAST_KEYS = ("extrinsic", "intrinsic")
# fp32 on both sides: summation order only, amplified by the random-init
# heads' exp / inverse-log activations (as in test_torch_model.py)
FP32_TOL = dict(rtol=2e-4, atol=1e-4)
# the unprojected points are a product of two such amplified quantities (the
# exp depth, up to 1e5 here, and the rays through 1 / tan(fov / 2)), so their
# relative errors add
UNPROJECTION_TOL = dict(rtol=5e-4, atol=1e-4)


def _tol(key, tol):
    return UNPROJECTION_TOL if key == "point_map_by_unprojection" else tol


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    cfg = JM.make_config(**TINY)
    jp = jax.jit(lambda k: JM.init_sailrecon(k, cfg))(jax.random.PRNGKey(0))
    anchors = rng.uniform(size=(1, A, 28, 28, 3)).astype(np.float32)
    queries = rng.uniform(size=(1, Q, 28, 28, 3)).astype(np.float32)
    P0 = (28 // 14) ** 2
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(4 * A)])
    idx = idx.reshape(4, 1, A, RANK).astype(np.int32)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    return dict(cfg=cfg, jp=jp, tp=tp, anchors=anchors, queries=queries, idx=idx,
                tcfg=TM.make_config(**TINY))


def _jax_build(s, cfg, **kw):
    fn = jax.jit(lambda p, x, i: JM.build_scene_cache(
        JM.cast_trunk_weights(p, cfg), cfg, x, rank=RANK, subsample_indices=i, **kw))
    return fn(s["jp"], jnp.asarray(s["anchors"]), jnp.asarray(s["idx"]))


def _jax_reloc(s, cfg, cache, cam, images=None, **kw):
    fn = jax.jit(lambda p, c, t, x: JM.reloc(
        JM.cast_trunk_weights(p, cfg), cfg, c, t, x, **kw))
    images = s["queries"] if images is None else images
    return _np(fn(s["jp"], cache, cam, jnp.asarray(images)))


@pytest.fixture(scope="module")
def jax_built(setup):
    """The JAX fp32 cache and cam token, and its full and fast reloc."""
    cache, cam = _jax_build(setup, setup["cfg"])
    return dict(cache=cache, cam=cam,
                full=_jax_reloc(setup, setup["cfg"], cache, cam),
                fast=_jax_reloc(setup, setup["cfg"], cache, cam, fast_reloc=True))


def _port_build(s, cfg=None, staged=False, **kw):
    cfg = cfg or s["tcfg"]
    fn = TM.build_scene_cache_staged if staged else TM.build_scene_cache
    return fn(TM.cast_trunk_weights(s["tp"], cfg), cfg, s["anchors"], rank=RANK,
              subsample_indices=torch.from_numpy(s["idx"]), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_built(setup):
    return _port_build(setup)


def _compare(out, ref, keys, **tol):
    for k in keys:
        a, b = out[k].float().numpy(), ref[k]
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        np.testing.assert_allclose(a[fin], b[fin], err_msg=k, **_tol(k, tol))
    for a, b in zip(out["pose_enc_list"], ref["pose_enc_list"]):
        np.testing.assert_allclose(a.float().numpy(), b, **tol)
    assert len(out["pose_enc_list"]) == len(ref["pose_enc_list"])


def _assert_equal(out, ref, keys):
    for k in keys:
        assert torch.equal(out[k], ref[k]), k
    for a, b in zip(out["pose_enc_list"], ref["pose_enc_list"]):
        assert torch.equal(a, b)


# -- pieces ---------------------------------------------------------------------


def test_block_context_kv_matches_jax(setup):
    rng = np.random.default_rng(1)
    jcfg, tcfg = setup["cfg"].aggregator.block_cfg, setup["tcfg"].aggregator.block_cfg
    ctx = rng.normal(size=(2, 7, 64)).astype(np.float32)
    ang = rng.uniform(0, 6.28, size=(2, 7, 16)).astype(np.float32)
    cos, sin = np.cos(ang), np.sin(ang)
    jrp = jax.tree.map(lambda x: x[1], setup["jp"]["aggregator"]["reloc_blocks"])
    jk, jv = JB.block_context_kv(jrp, jnp.asarray(ctx), jcfg,
                                 (jnp.asarray(cos), jnp.asarray(sin)))
    tk, tv = TB.block_context_kv(
        setup["tp"]["aggregator"]["reloc_blocks"][1], torch.from_numpy(ctx), tcfg,
        (torch.from_numpy(cos), torch.from_numpy(sin)))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("is_query", [[True] * 3, [False] * 3, [False, False, True]],
                         ids=["query_only", "anchor_only", "mixed"])
def test_embed_frames_matches_jax(setup, is_query):
    """A query-only embed has no anchor rows at all: the special tokens are
    selected per frame by the flag, as in the JAX function."""
    imgs = setup["queries"]
    jt, jP0 = JA._embed_frames(setup["jp"]["aggregator"], setup["cfg"].aggregator,
                               jnp.asarray(imgs), jnp.asarray(is_query))
    tt, tP0 = TA._embed_frames(setup["tp"]["aggregator"], setup["tcfg"].aggregator,
                               torch.from_numpy(imgs), is_query)
    assert tP0 == jP0 and tuple(tt.shape) == jt.shape == (1, 3, 4 + 5, 64)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    # the special tokens are 1e-6-scaled: compare them exactly where they sit
    np.testing.assert_allclose(tt[:, :, :5].numpy(), np.asarray(jt[:, :, :5]),
                               rtol=1e-6, atol=0)


def test_embed_frames_chunked_matches_jax(setup):
    imgs = setup["anchors"]
    jt, _ = JA._embed_frames(setup["jp"]["aggregator"], setup["cfg"].aggregator,
                             jnp.asarray(imgs), jnp.asarray([False] * A), frame_chunk=2)
    acfg = setup["tcfg"].aggregator
    tt, _ = TA._embed_frames(setup["tp"]["aggregator"], acfg, torch.from_numpy(imgs),
                             [False] * A, frame_chunk=2)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)
    whole, _ = TA._embed_frames(setup["tp"]["aggregator"], acfg,
                                torch.from_numpy(imgs), [False] * A)
    np.testing.assert_allclose(tt.numpy(), whole.numpy(), atol=1e-6)
    # a chunk that does not divide the frame count embeds in one piece
    nd, _ = TA._embed_frames(setup["tp"]["aggregator"], acfg, torch.from_numpy(imgs),
                             [False] * A, frame_chunk=4)
    assert torch.equal(nd, whole)
    with pytest.raises(ValueError, match="is_query"):
        TA._embed_frames(setup["tp"]["aggregator"], acfg, torch.from_numpy(imgs),
                         [False] * 2)


def test_pose_encoding_np64_matches_jax():
    enc = np.random.default_rng(2).normal(size=(2, 3, 9)).astype(np.float32)
    enc[..., 7:] = np.abs(enc[..., 7:]) + 0.2
    je, ji = JG.pose_encoding_to_extri_intri_np64(enc, (28, 42))
    te, ti = TG.pose_encoding_to_extri_intri_np64(enc, (28, 42))
    assert te.dtype == ti.dtype == np.float64
    np.testing.assert_allclose(te, je, atol=1e-12)
    np.testing.assert_allclose(ti, ji, atol=1e-12)
    te2, none = TG.pose_encoding_to_extri_intri_np64(enc, build_intrinsics=False)
    assert none is None and np.array_equal(te2, te)
    # and against the port's fp32 torch decode
    fe, fi = TG.pose_encoding_to_extri_intri(torch.from_numpy(enc), (28, 42))
    np.testing.assert_allclose(fe.numpy(), te, atol=1e-5)
    np.testing.assert_allclose(fi.numpy(), ti, rtol=1e-5)


@pytest.mark.parametrize("fp64_decode", [False, True])
def test_pose_forward_matches_jax(setup, fp64_decode):
    s = setup
    images = np.concatenate([s["anchors"][:, :3], s["queries"]], axis=1)
    je, ji = JM.pose_forward(s["jp"], s["cfg"], jnp.asarray(images), 3, Q,
                             fp64_decode=fp64_decode)
    te, ti = TM.pose_forward(s["tp"], s["tcfg"], images, 3, Q,
                             fp64_decode=fp64_decode, device="cpu")
    if fp64_decode:
        assert isinstance(te, np.ndarray) and te.dtype == np.float64
    else:
        te, ti = te.numpy(), ti.numpy()
    assert te.shape == (1, Q, 3, 4) and ti.shape == (1, Q, 3, 3)
    np.testing.assert_allclose(te, np.asarray(je), atol=1e-5)
    np.testing.assert_allclose(ti, np.asarray(ji), rtol=1e-5, atol=1e-5)


# -- build ----------------------------------------------------------------------


def test_build_scene_cache_matches_jax(setup, jax_built, port_built):
    cache, cam = port_built
    kv = cache["kv"]
    assert kv.dtype == torch.float32 and kv.is_contiguous()
    assert tuple(kv.shape) == (4, 1, 4, A * (RANK + 5), 2 * 16)
    np.testing.assert_allclose(kv.numpy(), np.asarray(jax_built["cache"]["kv"]),
                               atol=1e-5)
    assert cam.dtype == torch.float32 and tuple(cam.shape) == (1, A, 128)
    np.testing.assert_allclose(cam.numpy(), np.asarray(jax_built["cam"]), atol=1e-5)


def test_build_scene_cache_bf16_within_jax_envelope(setup, jax_built):
    """bf16 trunk on both sides; the port's error against JAX-bf16 stays
    within JAX's own bf16 envelope (max |JAX-bf16 - JAX-fp32|)."""
    jcfg = JM.make_config(compute_dtype="bfloat16", **TINY)
    jc, jcam = _jax_build(setup, jcfg)
    tcfg = TM.make_config(compute_dtype="bfloat16", **TINY)
    tc, tcam = _port_build(setup, tcfg)
    assert tc["kv"].dtype == torch.bfloat16
    for a, b, c in ((tc["kv"], jc["kv"], jax_built["cache"]["kv"]),
                    (tcam, jcam, jax_built["cam"])):
        a = a.float().numpy()
        b, c = (np.asarray(x.astype(jnp.float32)) for x in (b, c))
        assert np.abs(a - b).max() <= np.abs(b - c).max()


@pytest.mark.parametrize("kw", [
    dict(anchor_chunk=2), dict(anchor_chunk=2, chunk_embed=False),
    dict(anchor_chunk=3), dict(anchor_chunk=4), dict(anchor_chunk=6),
], ids=["chunk2", "chunk2_whole_embed", "chunk3", "chunk4_falls_back",
        "chunk6_degenerate"])
def test_chunked_build_matches_one_shot(setup, jax_built, port_built, kw):
    cache, cam = _port_build(setup, **kw)
    ref, ref_cam = port_built
    G = kw["anchor_chunk"]
    if A % G or G >= A:
        # a non-dividing or degenerate chunk runs the unchunked layers (and
        # the unchunked embed): the same program
        assert torch.equal(cache["kv"], ref["kv"]) and torch.equal(cam, ref_cam)
    else:
        # not bit-equal: the library matmuls (the unfused context K/V, the
        # QKV / MLP projections) and the ViT's convolution pick their
        # summation order by shape, and the chunk changes the row count
        np.testing.assert_allclose(cache["kv"].numpy(), ref["kv"].numpy(), atol=1e-5)
        np.testing.assert_allclose(cam.numpy(), ref_cam.numpy(), atol=1e-5)
    np.testing.assert_allclose(cache["kv"].numpy(),
                               np.asarray(jax_built["cache"]["kv"]), atol=1e-5)


def test_chunked_build_matches_jax_chunked(setup):
    jc, jcam = _jax_build(setup, setup["cfg"], anchor_chunk=2)
    tc, tcam = _port_build(setup, anchor_chunk=2)
    np.testing.assert_allclose(tc["kv"].numpy(), np.asarray(jc["kv"]), atol=1e-5)
    np.testing.assert_allclose(tcam.numpy(), np.asarray(jcam), atol=1e-5)


@pytest.mark.parametrize("kw", [dict(num_segments=2), dict(num_segments=4),
                                dict(num_segments=2, anchor_chunk=3)],
                         ids=["seg2", "seg4", "seg2_chunk3"])
def test_staged_build_matches_one_shot(setup, jax_built, port_built, kw):
    cache, cam = _port_build(setup, staged=True, **kw)
    assert cache["kv"].device.type == "cpu" and cam.device.type == "cpu"
    ref, ref_cam = port_built
    if "anchor_chunk" in kw:
        np.testing.assert_allclose(cache["kv"].numpy(), ref["kv"].numpy(), atol=1e-5)
        np.testing.assert_allclose(cam.numpy(), ref_cam.numpy(), atol=1e-5)
    else:
        # the same layers on the same values; only where the cache lives differs
        assert torch.equal(cache["kv"], ref["kv"]) and torch.equal(cam, ref_cam)
    np.testing.assert_allclose(cache["kv"].numpy(),
                               np.asarray(jax_built["cache"]["kv"]), atol=1e-5)


def test_staged_build_matches_jax_staged(setup):
    jc, jcam = JM.build_scene_cache_staged(
        setup["jp"], setup["cfg"], jnp.asarray(setup["anchors"]), rank=RANK,
        subsample_indices=jnp.asarray(setup["idx"]), num_segments=2, anchor_chunk=3)
    tc, tcam = _port_build(setup, staged=True, num_segments=2, anchor_chunk=3)
    np.testing.assert_allclose(tc["kv"].numpy(), jc["kv"], atol=1e-5)
    np.testing.assert_allclose(tcam.numpy(), jcam, atol=1e-5)


def test_segments_must_divide_depth(setup, port_built):
    with pytest.raises(ValueError, match="segments"):
        _port_build(setup, staged=True, num_segments=3)
    cache, cam = port_built
    with pytest.raises(ValueError, match="segments"):
        TM.reloc_staged(setup["tp"], setup["tcfg"], cache, cam, setup["queries"],
                        num_segments=3, device="cpu")


# -- reloc ----------------------------------------------------------------------


def _port_reloc(s, cache, cam, fn=TM.reloc, images=None, **kw):
    return fn(s["tp"], s["tcfg"], cache, cam,
              s["queries"] if images is None else images, device="cpu", **kw)


@pytest.fixture(scope="module")
def port_reloc_full(setup, port_built):
    return _port_reloc(setup, *port_built)


def test_reloc_matches_jax(setup, jax_built, port_reloc_full):
    out = port_reloc_full
    assert tuple(out["xyz_conf_fractions"].shape) == (1, Q, 18)
    _compare(out, jax_built["full"], KEYS, **FP32_TOL)


def test_fast_reloc_matches_jax(setup, jax_built, port_built):
    out = _port_reloc(setup, *port_built, fast_reloc=True)
    assert sorted(out) == ["extrinsic", "intrinsic", "pose_enc_list"]
    _compare(out, jax_built["fast"], FAST_KEYS, **FP32_TOL)


def test_reloc_on_a_jax_built_cache(setup, jax_built):
    """The JAX cache through ``convert.cache_from_jax`` serves the port."""
    cache = convert.cache_from_jax({"kv": np.asarray(jax_built["cache"]["kv"])})
    cam = torch.from_numpy(np.array(jax_built["cam"]))
    _compare(_port_reloc(setup, cache, cam), jax_built["full"], KEYS, **FP32_TOL)
    _compare(_port_reloc(setup, cache, cam, fast_reloc=True), jax_built["fast"],
             FAST_KEYS, **FP32_TOL)


def test_jax_reloc_on_a_port_built_cache(setup, jax_built, port_built):
    """And the other way: the port's cache tensor is a kv2 cache of the JAX
    package as it stands."""
    cache, cam = port_built
    out = _jax_reloc(setup, setup["cfg"], {"kv": jnp.asarray(cache["kv"].numpy())},
                     jnp.asarray(cam.numpy()))
    for k in KEYS:
        fin = np.isfinite(jax_built["full"][k])
        np.testing.assert_allclose(out[k][fin], jax_built["full"][k][fin], err_msg=k,
                                   **_tol(k, FP32_TOL))


@pytest.mark.parametrize("layout", ["heads", "packed", "kv2"])
def test_cache_from_jax_reads_every_layout(setup, jax_built, layout):
    import dataclasses

    jcfg = setup["cfg"]
    lcfg = dataclasses.replace(jcfg, aggregator=dataclasses.replace(
        jcfg.aggregator, cache_layout=layout))
    cache, _ = _jax_build(setup, lcfg)
    if layout != "kv2":
        assert sorted(cache) == ["k", "v"]
    # bfloat16 leaves too (numpy holds them as an extension dtype)
    as_bf16 = {k: np.asarray(v.astype(jnp.bfloat16)) for k, v in cache.items()}
    out = convert.cache_from_jax(jax.tree.map(np.asarray, cache), num_heads=4)
    ref = np.asarray(jax_built["cache"]["kv"])
    assert tuple(out["kv"].shape) == ref.shape
    np.testing.assert_allclose(out["kv"].numpy(), ref, atol=1e-6)
    out16 = convert.cache_from_jax(as_bf16, torch.bfloat16, num_heads=4)
    assert out16["kv"].dtype == torch.bfloat16
    assert torch.equal(out16["kv"], out["kv"].to(torch.bfloat16))
    if layout == "packed":
        with pytest.raises(ValueError, match="num_heads"):
            convert.cache_from_jax(as_bf16)


def test_reloc_chunked_matches_reloc(setup, jax_built, port_built, port_reloc_full):
    out = _port_reloc(setup, *port_built, fn=TM.reloc_chunked, chunk=2)
    for k in KEYS:
        assert out[k].shape == port_reloc_full[k].shape, k
        a, b = out[k].numpy(), port_reloc_full[k].numpy()
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], atol=5e-5, rtol=1e-4, err_msg=k)
    _compare(out, jax_built["full"], KEYS, **FP32_TOL)
    fast = _port_reloc(setup, *port_built, fn=TM.reloc_chunked, chunk=2,
                       fast_reloc=True)
    _compare(fast, jax_built["fast"], FAST_KEYS, **FP32_TOL)
    # a chunk that divides Q pads nothing: the same program per chunk
    whole = _port_reloc(setup, *port_built, fn=TM.reloc_chunked, chunk=3)
    _assert_equal(whole, port_reloc_full, KEYS)


def test_reloc_chunked_matches_jax_chunked(setup, jax_built):
    fn = jax.jit(lambda p, c, t, x: JM.reloc_chunked(p, setup["cfg"], c, t, x, chunk=2))
    ref = _np(fn(setup["jp"], jax_built["cache"], jax_built["cam"],
                 jnp.asarray(setup["queries"])))
    cache = convert.cache_from_jax({"kv": np.asarray(jax_built["cache"]["kv"])})
    cam = torch.from_numpy(np.array(jax_built["cam"]))
    out = _port_reloc(setup, cache, cam, fn=TM.reloc_chunked, chunk=2)
    _compare(out, ref, KEYS, **FP32_TOL)


@pytest.mark.parametrize("num_segments", [2, 4])
def test_reloc_staged_equals_reloc(setup, port_built, port_reloc_full, num_segments):
    """Bit-equal: the same ops on the same values; only where the cache lives
    differs. The host cache is a CPU tensor."""
    cache, cam = _port_build(setup, staged=True, num_segments=num_segments)
    assert cache["kv"].device.type == "cpu"
    out = _port_reloc(setup, cache, cam, fn=TM.reloc_staged, num_segments=num_segments)
    _assert_equal(out, port_reloc_full, KEYS)
    fast = _port_reloc(setup, cache, cam, fn=TM.reloc_staged,
                       num_segments=num_segments, fast_reloc=True)
    _assert_equal(fast, port_reloc_full, FAST_KEYS)


def test_reloc_staged_matches_jax_staged(setup, jax_built):
    host = {"kv": np.asarray(jax_built["cache"]["kv"])}
    ref = _np(JM.reloc_staged(setup["jp"], setup["cfg"], host,
                              np.asarray(jax_built["cam"]),
                              jnp.asarray(setup["queries"]), num_segments=2))
    out = _port_reloc(setup, convert.cache_from_jax(host),
                      torch.from_numpy(np.array(jax_built["cam"])),
                      fn=TM.reloc_staged, num_segments=2)
    _compare(out, ref, KEYS, **FP32_TOL)


def test_reloc_through_the_packed_wrapper_matches_jax(setup, jax_built, port_built,
                                                      monkeypatch):
    """attn_impl="flash": every reloc layer goes through the in-place kv2
    wrapper with its layer index (its plain version on the CPU), every frame
    block through the flash wrapper; K2 is not on this path."""
    calls = {"frame_ctx_packed_fwd": [], "flash_fwd": 0, "frame_ctx_fwd": 0}
    orig = TFA.frame_ctx_packed_fwd

    def packed(q, k, v, ckv, layer):
        calls["frame_ctx_packed_fwd"].append((layer, ckv.shape[0]))
        return orig(q, k, v, ckv, layer)

    def counted(name):
        fn = getattr(TFA, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TFA, "frame_ctx_packed_fwd", packed)
    monkeypatch.setattr(TFA, "flash_fwd", counted("flash_fwd"))
    monkeypatch.setattr(TFA, "frame_ctx_fwd", counted("frame_ctx_fwd"))
    cfg = TM.make_config(**TINY, attn_impl="flash")
    cache, cam = port_built
    out = TM.reloc(setup["tp"], cfg, cache, cam, setup["queries"], device="cpu")
    assert calls["frame_ctx_packed_fwd"] == [(l, 4) for l in range(4)]
    assert calls["flash_fwd"] == TINY["vit_depth"] + TINY["depth"]
    assert calls["frame_ctx_fwd"] == 0
    _compare(out, jax_built["full"], KEYS, **FP32_TOL)
    # staged: the layer index is the place inside the uploaded segment
    calls["frame_ctx_packed_fwd"].clear()
    st = TM.reloc_staged(setup["tp"], cfg, cache, cam, setup["queries"],
                         num_segments=2, device="cpu")
    assert calls["frame_ctx_packed_fwd"] == [(0, 2), (1, 2), (0, 2), (1, 2)]
    _assert_equal(st, out, KEYS)


def test_reloc_bf16_within_jax_envelope(setup, jax_built):
    """bf16 trunk (the fused block functions on the port's side), fp32 heads:
    per output the port's error against JAX-bf16 stays within JAX's own bf16
    envelope; finite masks agree."""
    jcfg = JM.make_config(compute_dtype="bfloat16", **TINY)
    jc, jcam = _jax_build(setup, jcfg)
    ref = _jax_reloc(setup, jcfg, jc, jcam)
    tcfg = TM.make_config(compute_dtype="bfloat16", **TINY)
    p = TM.cast_trunk_weights(setup["tp"], tcfg)
    cache = convert.cache_from_jax({"kv": np.asarray(jc["kv"].astype(jnp.float32))},
                                   torch.bfloat16)
    out = TM.reloc(p, tcfg, cache, torch.from_numpy(np.array(jcam)),
                   setup["queries"], device="cpu")
    for k in KEYS:
        a, b, c = out[k].float().numpy(), ref[k], jax_built["full"][k]
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=k)
        fin = np.isfinite(a) & np.isfinite(b) & np.isfinite(c)
        # the fractions are means of 0 / 1 over the same pixels: where the
        # counts agree only the mean's own rounding (1e-8) is left
        slack = 1e-6 if k == "xyz_conf_fractions" else 0.0
        assert np.abs(a - b)[fin].max() <= np.abs(b - c)[fin].max() + slack, k


# -- the device rule --------------------------------------------------------------


def test_serving_entry_points_refuse_to_fall_back_to_the_cpu(setup, port_built,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s, cfg = setup, setup["tcfg"]
    cache, cam = port_built
    idx = torch.from_numpy(s["idx"])
    calls = [
        lambda: TM.build_scene_cache(s["tp"], cfg, s["anchors"], rank=RANK,
                                     subsample_indices=idx),
        lambda: TM.build_scene_cache_staged(s["tp"], cfg, s["anchors"], rank=RANK,
                                            subsample_indices=idx),
        lambda: TM.reloc(s["tp"], cfg, cache, cam, s["queries"]),
        lambda: TM.reloc(s["tp"], cfg, cache, cam, s["queries"], fast_reloc=True),
        lambda: TM.reloc_chunked(s["tp"], cfg, cache, cam, s["queries"], chunk=2),
        lambda: TM.reloc_staged(s["tp"], cfg, cache, cam, s["queries"]),
        lambda: TM.pose_forward(s["tp"], cfg, s["queries"], 1, 2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_reloc_refuses_a_cache_on_another_device(setup, port_built):
    cache, cam = port_built
    meta = {"kv": cache["kv"].to("meta")}
    with pytest.raises(ValueError, match="reloc_staged"):
        TM.reloc(setup["tp"], setup["tcfg"], meta, cam, setup["queries"], device="cpu")


def test_new_modules_are_covered_by_the_import_walk():
    """test_torch_model.py walks every ``*.py`` of the port for JAX imports;
    the modules of this slice must be among them, and import torch only."""
    import ast

    pkg = ROOT / "self_supervise_sfm_tpu_torch"
    for rel in ("ops/mask_spec.py", "ops/attention_core.py", "ops/flash_attention.py",
                "models/aggregator.py", "models/sailrecon.py", "convert.py"):
        path = pkg / rel
        assert path in set(pkg.rglob("*.py"))
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "self_supervise_sfm_tpu")
