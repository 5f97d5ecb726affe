"""PyTorch port: the tracker and the keypoint extractors against the JAX
package, and K3's launch choice.

Weights: the JAX package's ``init_vggsfm_tracker`` / ``init_superpoint``
converted by ``convert.tracker_from_jax`` / ``superpoint_from_jax``, so both
packages run identical weights. The tracker is ``tests/test_pipeline.py``'s
small configuration (coarse depth 2, hidden 64; fine depth 2, hidden 64,
``pradius`` 7). Tolerance 1e-4 (pixels, features), fp32 in both.

The predictor is iterated, and at random weights each iteration multiplies
a difference in its coordinates by ~50 (the flow embedding's frequencies
reach ~1000 / C, so an ulp of a coordinate moves the embedding by 1e-4 of
it): fp32 rounding alone then separates the two packages by pixels after
five iterations. So the predictor, ``refine_track`` and ``track`` are held
at one coarse and one fine iteration, where the comparison measures the
port and not the amplification.

The shallow encoder runs at a patch count under K3's size gate (the einsum
resize in both packages) and at one over it (4365 patches of 31 x 31: the
port's K3 wrapper, on the CPU its plain version; the JAX package's einsum,
since its gate is on the TPU only). SuperPoint and the DoG detector give
the same keypoints, exactly.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.heads import track_modules as JTM
from self_supervise_sfm_tpu.heads import track_utils as JTU
from self_supervise_sfm_tpu.pipeline import extractors as JX
from self_supervise_sfm_tpu.pipeline import vggsfm_tracker as JV
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.heads import track_modules as TTM
from self_supervise_sfm_tpu_torch.heads import track_utils as TTU
from self_supervise_sfm_tpu_torch.ops import resize as TRS
from self_supervise_sfm_tpu_torch.pipeline import extractors as TX
from self_supervise_sfm_tpu_torch.pipeline import vggsfm_tracker as TV

torch.set_num_threads(1)
ATOL = 1e-4


def small_cfg(M, **kw):
    return M.VGGSfMTrackerConfig(
        coarse=M.VGGSfMPredictorConfig(stride=4, depth=2, corr_levels=2, corr_radius=2,
                                       hidden_size=64),
        fine=M.VGGSfMPredictorConfig(stride=1, depth=2, corr_levels=3, corr_radius=3,
                                     latent_dim=32, hidden_size=64, fine=True,
                                     use_spaceatt=False),
        pradius=7, **kw)


@pytest.fixture(scope="module")
def tracker():
    jcfg = small_cfg(JV, fine_iters=1)
    jp = jax.jit(lambda k: JV.init_vggsfm_tracker(k, jcfg))(jax.random.PRNGKey(0))
    tp = convert.tracker_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp, jcfg, small_cfg(TV, fine_iters=1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol, rtol=0)


# -- track_utils --------------------------------------------------------------------


@pytest.mark.parametrize("padding_mode", ["border", "zeros"])
@pytest.mark.parametrize("align_corners", [True, False])
def test_bilinear_sample_matches_jax(rng, padding_mode, align_corners):
    img = rng.normal(size=(9, 11, 5)).astype(np.float32)
    # inside, on the edges and past them on every side
    xy = rng.uniform(-3, 14, size=(7, 13, 2)).astype(np.float32)
    xy[0, :4] = [[0, 0], [10, 8], [-1, 4], [11, 4]]
    ref = JTU.bilinear_sample_nhwc(jnp.asarray(img), jnp.asarray(xy), align_corners,
                                   padding_mode)
    got = TTU.bilinear_sample_nhwc(_t(img), _t(xy), align_corners, padding_mode)
    _close(got, ref, atol=1e-6)
    _close(TTU.sample_features(_t(img), _t(xy[0])), JTU.sample_features(
        jnp.asarray(img), jnp.asarray(xy[0])), atol=1e-6)


def test_embeddings_match_jax(rng):
    _close(TTU.get_2d_sincos_pos_embed(68, (5, 7)), JTU.get_2d_sincos_pos_embed(68, (5, 7)),
           atol=0)
    xy = rng.uniform(-20, 20, size=(2, 6, 2)).astype(np.float32)
    for cat in (True, False):
        _close(TTU.get_2d_embedding(_t(xy), 64, cat), JTU.get_2d_embedding(jnp.asarray(xy), 64,
                                                                           cat), atol=1e-5)


# -- track_modules -------------------------------------------------------------------


def test_attention_blocks_match_jax(rng, tracker):
    jp, tp, _, _ = tracker
    jb = jp["coarse_predictor"]["updateformer"]
    tb = tp["coarse_predictor"]["updateformer"]
    x = rng.normal(size=(3, 6, 64)).astype(np.float32)
    ctx = rng.normal(size=(3, 9, 64)).astype(np.float32)
    _close(TTM.mha(tb["time_blocks"][0]["attn"], _t(x), _t(ctx), 8),
           JTM.mha(jb["time_blocks"][0]["attn"], jnp.asarray(x), jnp.asarray(ctx), 8))
    _close(TTM.attn_block(tb["time_blocks"][1], _t(x), 8, 1e-6),
           JTM.attn_block(jb["time_blocks"][1], jnp.asarray(x), 8, 1e-6))
    _close(TTM.cross_attn_block(tb["space_point2virtual_blocks"][0], _t(x), _t(ctx), 8, 1e-6),
           JTM.cross_attn_block(jb["space_point2virtual_blocks"][0], jnp.asarray(x),
                                jnp.asarray(ctx), 8, 1e-6))


@pytest.mark.parametrize("which", ["coarse", "fine"])
def test_updateformer_matches_jax(rng, tracker, which):
    jp, tp, jcfg, tcfg = tracker
    jc, tc = getattr(jcfg, which).updateformer_cfg, getattr(tcfg, which).updateformer_cfg
    x = rng.normal(size=(1, 10, 3, jc.input_dim)).astype(np.float32)
    key = f"{which}_predictor"
    ref = jax.jit(partial(JTM.updateformer, cfg=jc))(jp[key]["updateformer"], jnp.asarray(x))
    _close(TTM.updateformer(tp[key]["updateformer"], _t(x), tc), ref)


def test_pyramid_and_corr_sample_match_jax(rng):
    fm = rng.normal(size=(1, 3, 9, 11, 16)).astype(np.float32)
    for lv in (1, 3, 5):  # 5 levels: pooling stops at the 1-px side
        for a, b in zip(TTM.build_fmap_pyramid(_t(fm), lv),
                        JTM.build_fmap_pyramid(jnp.asarray(fm), lv)):
            _close(a, b, atol=1e-6)
    coords = rng.uniform(-2, 12, size=(1, 3, 7, 2)).astype(np.float32)
    tg = rng.normal(size=(1, 3, 7, 16)).astype(np.float32)
    jpyr = JTM.build_fmap_pyramid(jnp.asarray(fm), 3)
    tpyr = TTM.build_fmap_pyramid(_t(fm), 3)
    _close(TTM.corr_sample(tpyr, _t(tg), _t(coords), 2),
           JTM.corr_sample(jpyr, jnp.asarray(tg), jnp.asarray(coords), 2), atol=1e-5)


# -- the tracker ------------------------------------------------------------------------


def test_encoders_match_jax(rng, tracker):
    jp, tp, _, _ = tracker
    x = rng.uniform(size=(2, 32, 40, 3)).astype(np.float32)
    _close(TV.instance_norm(_t(x)), JV.instance_norm(jnp.asarray(x)), atol=1e-5)
    rb = jp["coarse_fnet"]["layer2"][0]
    y = rng.normal(size=(2, 12, 10, 64)).astype(np.float32)
    _close(TV.residual_block(tp["coarse_fnet"]["layer2"][0], _t(y), 2),
           JV.residual_block(rb, jnp.asarray(y), 2))
    ref = jax.jit(JV.basic_encoder)(jp["coarse_fnet"], jnp.asarray(x))
    _close(TV.basic_encoder(tp["coarse_fnet"], _t(x)), ref)


@pytest.mark.parametrize("patches", [12, 4365])
def test_shallow_encoder_matches_jax_on_both_sides_of_the_gate(rng, tracker, monkeypatch,
                                                               patches):
    """4365 patches of 31 x 31 x 32 are the fewest whose final upsample
    (>= 2^27 output elements) the port's gate sends to K3."""
    jp, tp, _, _ = tracker
    calls = []
    orig = TRS.resize_bilinear_fwd

    def recorded(x, out_hw, *a, **k):
        calls.append(tuple(x.shape))
        return orig(x, out_hw, *a, **k)

    monkeypatch.setattr(TRS, "resize_bilinear_fwd", recorded)
    x = rng.uniform(size=(patches, 31, 31, 3)).astype(np.float32)
    got = TV.shallow_encoder(tp["fine_fnet"], _t(x))
    assert calls == ([(patches, 16, 16, 32)] if patches >= 4365 else [])
    # each patch is encoded on its own (instance norm per patch): the JAX
    # package's output for the first 12 patches is the reference for them
    ref = jax.jit(JV.shallow_encoder)(jp["fine_fnet"], jnp.asarray(x[:12]))
    _close(got[:12], ref)


def test_predictor_matches_jax(rng, tracker):
    jp, tp, jcfg, tcfg = tracker
    fm = rng.normal(size=(1, 3, 8, 8, 128)).astype(np.float32)
    q = rng.uniform(4, 56, size=(1, 9, 2)).astype(np.float32)
    jf = jax.jit(partial(JV.vggsfm_predictor, cfg=jcfg.coarse, iters=1, down_ratio=2))
    jc, jvis = jf(jp["coarse_predictor"], jnp.asarray(q), jnp.asarray(fm))
    tc, tvis = TV.vggsfm_predictor(tp["coarse_predictor"], _t(q), _t(fm), tcfg.coarse,
                                   iters=1, down_ratio=2)
    _close(tc[-1], jc[-1])
    _close(tvis, jvis, atol=1e-5)


def test_track_and_refine_match_jax(rng, tracker):
    jp, tp, jcfg, tcfg = tracker
    images = rng.uniform(size=(1, 3, 64, 64, 3)).astype(np.float32)
    q = rng.uniform(8, 56, size=(1, 10, 2)).astype(np.float32)
    jtrack = jax.jit(partial(JV.track, cfg=jcfg, coarse_iters=1))
    jfine, jcoarse, jvis = jtrack(jp, jnp.asarray(images), jnp.asarray(q))
    fine, coarse, vis = TV.track(tp, images, q, tcfg, coarse_iters=1, device="cpu")
    _close(coarse, jcoarse)
    _close(fine, jfine)
    _close(vis, jvis, atol=1e-5)
    # the query frame keeps the query points
    np.testing.assert_array_equal(fine[0, 0].numpy(), q[0])
    # refine_track alone, on the JAX coarse tracks
    ref = jax.jit(partial(JV.refine_track, cfg=jcfg))(
        jnp.asarray(images), jp["fine_fnet"], jp["fine_predictor"], jcoarse)
    got = TV.refine_track(_t(images), tp["fine_fnet"], tp["fine_predictor"],
                          _t(np.asarray(jcoarse)), tcfg)
    _close(got, ref)
    c2, c3, _ = TV.track(tp, images, q, tcfg, coarse_iters=1, fine_tracking=False,
                         device="cpu")
    assert torch.equal(c2, coarse) and torch.equal(c3, coarse)


def test_extract_patches_matches_jax(rng):
    images = rng.normal(size=(2, 20, 24, 3)).astype(np.float32)
    tl = rng.integers(-3, 22, size=(2, 5, 2)).astype(np.int32)
    _close(TV.extract_patches(_t(images), _t(tl).long(), 7),
           JV.extract_patches(jnp.asarray(images), jnp.asarray(tl), 7), atol=0)


def test_cuda_is_the_default_and_raises_without_a_card(tracker):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, tp, _, tcfg = tracker
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.track(tp, np.zeros((1, 2, 32, 32, 3), np.float32), np.zeros((1, 1, 2), np.float32),
                 tcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TV.init_vggsfm_tracker(tcfg, torch.Generator().manual_seed(0))


# -- extractors ---------------------------------------------------------------------------


def _image(rng):
    img = np.zeros((64, 72, 3), np.float32)
    img[12:40, 16:50] = 1.0
    img[44:58, 8:30] = 0.5
    return img + rng.uniform(0, 0.05, size=img.shape).astype(np.float32)


def test_superpoint_keypoints_exact(rng):
    jsp = jax.jit(JX.init_superpoint)(jax.random.PRNGKey(0))
    tsp = convert.superpoint_from_jax(jax.tree_util.tree_map(np.asarray, jsp))
    img = _image(rng)
    jxy, js, jd = JX.superpoint_keypoints(jsp, jnp.asarray(img), 64)
    txy, ts, td = TX.superpoint_keypoints(tsp, _t(img), 64)
    keep = np.asarray(js) > 0
    assert keep.sum() > 0
    np.testing.assert_array_equal(txy.numpy()[keep], np.asarray(jxy)[keep])
    np.testing.assert_array_equal(ts.numpy() > 0, keep)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(td.numpy()[keep], np.asarray(jd)[keep], atol=1e-4)


def test_dog_keypoints_and_union_exact(rng):
    img = _image(rng)
    jxy, js = jax.jit(partial(JX.dog_keypoints, max_pts=128))(jnp.asarray(img))
    txy, ts = TX.dog_keypoints(_t(img), 128)
    keep = np.asarray(js) > 0
    assert keep.sum() > 0
    np.testing.assert_array_equal(txy.numpy()[keep], np.asarray(jxy)[keep])
    np.testing.assert_array_equal(ts.numpy() > 0, keep)
    jzoo = JX.initialize_feature_extractors("shi_tomasi", max_pts=128)
    jzoo["dog"] = lambda im: np.asarray(jxy)[keep]
    tzoo = TX.initialize_feature_extractors("shi_tomasi+dog", max_pts=128, device="cpu")
    np.testing.assert_array_equal(TX.extract_keypoints_union(img, tzoo),
                                  JX.extract_keypoints_union(img, jzoo))
    # the zoo's "aliked" (held against JAX in tests/test_torch_aliked.py)
    zoo = TX.initialize_feature_extractors("shi_tomasi+aliked", max_pts=128, device="cpu")
    xy = zoo["aliked"](img)
    assert xy.ndim == 2 and xy.shape[1] == 2 and 0 < len(xy) <= 128
    union = TX.extract_keypoints_union(img, zoo)
    assert len(union) >= len(xy)


# -- K3's launch choice (meta tensors: the card's checks, no build) ------------------------


@pytest.fixture
def k3_launches(monkeypatch):
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(args))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    return seen


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def test_k3_chunk_every_image_at_the_dpt_site_many_at_the_trackers(k3_launches):
    """The chunk is the entry's sixth argument (after x, add, out, out_bf16
    and the image count)."""
    TRS.resize_bilinear_fwd(_meta(5, 296, 296, 128), (518, 518), _meta(518, 518, 128),
                            torch.bfloat16)
    TRS.resize_bilinear_fwd(_meta(5120, 16, 16, 32), (31, 31))
    (dpt, trk) = k3_launches
    assert dpt[4:6] == (5, 5)  # one chunk of every image: the launch before the chunks
    n, chunk = trk[4:6]
    assert n == 5120 and 1 < chunk < n and -(-n // chunk) > 1
    # 16 pixel blocks x 256 chunks of 20 images: a few waves of 132 SMs at 8
    # resident blocks each
    assert chunk == 20
    blocks = -(-31 * 31 * 4 // TRS.THREADS) * -(-n // chunk)
    assert blocks == 4096 >= 3 * 132 * 8
    with pytest.raises(ValueError, match="image chunk"):
        TRS.resize_bilinear_fwd(_meta(5120, 16, 16, 32), (31, 31), img_chunk=0)
