"""PyTorch port, the ALIKED extractor (``pipeline/aliked.py``) against the
JAX package's on 64 x 64 images, with JAX's param shapes filled with seeded
numpy values (the offset predictors nonzero, so that the deformable
convolutions and SDDH sample off the grid) and carried across by
``convert.from_jax_params`` (HWIO convs -> OIHW).

Tolerances, fp32: ``deform_conv`` 1e-5 (summation order; its taps outside
the map read zero in both), ``aliked_dense`` scores and features 1e-5,
``sddh_descriptors`` 1e-5, ``_softargmax_refine`` 1e-5 px;
``aliked_keypoints``' scores 1e-5, and its keypoints and descriptors equal
within 1e-4 wherever a score stands more than 1e-5 from its neighbours in
the ranking (the top-k order is otherwise a matter of rounding). The zoo's
``"aliked"`` against the JAX zoo's on the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.pipeline import aliked as JA
from self_supervise_sfm_tpu.pipeline import extractors as JX
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.pipeline import aliked as TA
from self_supervise_sfm_tpu_torch.pipeline import extractors as TX
from tests.test_torch_converter import random_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def params():
    jp = random_params(lambda: JA.init_aliked(jax.random.PRNGKey(0)), seed=3)
    return jp, convert.from_jax_params(jp)


@pytest.fixture(scope="module")
def dense(params):
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    js, jf = jax.jit(JA.aliked_dense)(params[0], jnp.asarray(images))
    return images, np.asarray(js), np.asarray(jf)


def test_deform_conv_matches_jax(rng):
    x = rng.normal(size=(2, 9, 8, 5)).astype(np.float32)
    off = (2.0 * rng.normal(size=(2, 9, 8, 18))).astype(np.float32)  # taps fall outside
    w = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = JA.deform_conv(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w), jnp.asarray(b))
    got = TA.deform_conv(torch.from_numpy(x), torch.from_numpy(off),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_aliked_dense_matches_jax(params, dense):
    images, js, jf = dense
    s, f = TA.aliked_dense(params[1], torch.from_numpy(images))
    assert s.shape == (2, 64, 64) and f.shape == (2, 64, 64, 128)
    np.testing.assert_allclose(s.numpy(), js, **TOL)
    np.testing.assert_allclose(f.numpy(), jf, **TOL)


def test_sddh_descriptors_match_jax(params, dense, rng):
    feats = dense[2][0]
    xy = rng.uniform(0, 63, size=(40, 2)).astype(np.float32)
    xy[:4] = [[0, 0], [63, 63], [0.5, 62.7], [62.9, 0.2]]  # samples past the edges
    want = jax.jit(JA.sddh_descriptors)(params[0], jnp.asarray(feats), jnp.asarray(xy))
    got = TA.sddh_descriptors(params[1], torch.from_numpy(feats.copy()), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_softargmax_refine_matches_jax(dense, rng):
    scores = dense[1][1].copy()
    xy = rng.integers(0, 64, size=(50, 2)).astype(np.float32)
    xy[:3] = [[0, 0], [63, 63], [1, 62]]  # neighbourhoods clamped at the edges
    want = JA._softargmax_refine(jnp.asarray(scores), jnp.asarray(xy))
    got = TA._softargmax_refine(torch.from_numpy(scores), torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _separated(vals, gap):
    """Entries whose score is more than ``gap`` from the next and previous
    score in the ranking, and above 0."""
    d = np.abs(np.diff(vals))
    sep = np.ones(len(vals), bool)
    sep[1:] &= d > gap
    sep[:-1] &= d > gap
    return sep & (vals > 0)


HW = (60, 50)  # zero-padded to 64 x 64


def test_aliked_keypoints_match_jax(params, rng):
    """The whole pipeline, on a frame that is padded."""
    image = rng.uniform(size=(*HW, 3)).astype(np.float32)
    jxy, jv, jd = (np.asarray(a) for a in JA.aliked_keypoints(params[0], jnp.asarray(image),
                                                               64))
    xy, v, d = TA.aliked_keypoints(params[1], torch.from_numpy(image), 64)
    assert xy.shape == (64, 2) and v.shape == (64,) and d.shape == (64, 128)
    np.testing.assert_allclose(v.numpy(), jv, **TOL)
    keep = _separated(jv, 1e-5)
    assert keep.sum() >= 16
    np.testing.assert_allclose(xy.numpy()[keep], jxy[keep], rtol=0, atol=1e-4)
    np.testing.assert_allclose(d.numpy()[keep], jd[keep], rtol=0, atol=1e-4)


def test_zoo_aliked_matches_jax(params, monkeypatch, rng):
    """``initialize_feature_extractors("aliked")``, both zoos' seeded
    weights replaced by the same params, on an RGB and a grayscale image."""
    monkeypatch.setattr(JA, "init_aliked", lambda key: params[0])
    monkeypatch.setattr(TA, "init_aliked", lambda g, device: params[1])
    tzoo = TX.initialize_feature_extractors("aliked", max_pts=64, device="cpu")
    jzoo = JX.initialize_feature_extractors("aliked", max_pts=64)
    yy, xx = np.mgrid[:HW[0], :HW[1]]
    rgb = (((yy // 8) + (xx // 8)) % 2)[..., None] * np.array([0.9, 0.6, 0.3])
    rgb = (rgb + 0.05 * rng.uniform(size=rgb.shape)).astype(np.float32)
    for img in (rgb, rgb.mean(-1)):
        got, want = tzoo["aliked"](img), jzoo["aliked"](img)
        assert len(got) == len(want) > 0
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_init_matches_jax_structure(params):
    """The port's init draws the JAX package's tree at its shapes, with the
    offset predictors zero; the default device is the card."""
    from tests.test_torch_converter import _with_paths

    tp = TA.init_aliked(torch.Generator().manual_seed(0), device="cpu")
    got = [(p, tuple(t.shape)) for p, t in _with_paths(tp)]
    assert got == [(p, tuple(t.shape)) for p, t in _with_paths(params[1])]
    assert all(not tp[n]["w"].any() for n in ("b3_off1", "b4_off2", "sddh_off"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TA.init_aliked(torch.Generator())
