"""PyTorch port, the in-model TrackHead (``heads/track.py``) against the JAX
package's, on the same params (JAX's param shapes filled with seeded numpy
values, carried across by ``convert.from_jax_params``) and inputs.

The small config of ``tests/test_track_head.py``'s reference test: 56 px
frames (a 4 x 4 patch grid, 5 special tokens), 3 frames, ``dim_in`` 32,
features 16, hidden 32, 3 correlation levels of radius 2, depth 2, taps
(0, 1, 2, 3), 2 iterations, 6 fixed query points. (At 28 px the 7-level
pyramid of the default config would run out of pixels.) Tolerances, fp32:
the DPT feature maps 1e-5 (summation order of the convolutions), the
tracks 1e-4 px after the first iteration and 1e-3 px after the second
(at random weights the iterated predictor amplifies fp32 rounding ~50x an
iteration: 3.8e-6 then 2.0e-4 px here), visibility and confidence 1e-5;
the gradient of a scalar
of the tracker's outputs with respect to the feature maps and to a
correlation-MLP weight rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.heads import dpt as JD
from self_supervise_sfm_tpu.heads import track as JH
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.heads import dpt as TD
from self_supervise_sfm_tpu_torch.heads import track as TH
from tests.test_torch_converter import random_params

torch.set_num_threads(1)

KW = dict(dim_in=32, features=16, iters=2, corr_levels=3, corr_radius=2, hidden_size=32,
          depth=2, intermediate_layer_idx=(0, 1, 2, 3))
H = W = 56
B, S, PSI = 1, 3, 5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jcfg, tcfg = JH.TrackHeadConfig(**KW), TH.TrackHeadConfig(**KW)
    jp = random_params(lambda: JH.init_track_head(jax.random.PRNGKey(0), jcfg))
    tp = convert.from_jax_params(jp)
    P = PSI + (H // 14) * (W // 14)
    taps = [rng.normal(size=(B, S, P, 32)).astype(np.float32) for _ in range(4)]
    qp = rng.uniform(10, 40, size=(B, 6, 2)).astype(np.float32)
    jtaps = {i: jnp.asarray(t) for i, t in enumerate(taps)}
    jfmaps = jax.jit(lambda p, t: JD.dpt_head(p, t, (H, W), PSI, jcfg.feature_extractor_cfg))(
        jp["feature_extractor"], jtaps)
    jout = jax.jit(lambda p, t, q: JH.track_head(p, t, (H, W), PSI, q, jcfg))(
        jp, jtaps, jnp.asarray(qp))
    return dict(jp=jp, tp=tp, jcfg=jcfg, tcfg=tcfg, qp=qp, jfmaps=np.asarray(jfmaps),
                jout=jax.tree_util.tree_map(np.asarray, jout),
                taps={i: torch.from_numpy(t) for i, t in enumerate(taps)})


def test_feature_maps_match_jax(setup):
    f = TD.dpt_head(setup["tp"]["feature_extractor"], setup["taps"], (H, W), PSI,
                    setup["tcfg"].feature_extractor_cfg)
    assert f.shape == (B, S, H // 2, W // 2, 16) == setup["jfmaps"].shape
    np.testing.assert_allclose(f.numpy(), setup["jfmaps"], rtol=1e-5, atol=1e-5)


def test_track_head_matches_jax(setup):
    coords, vis, conf = TH.track_head(setup["tp"], setup["taps"], (H, W), PSI,
                                      torch.from_numpy(setup["qp"]), setup["tcfg"])
    jcoords, jvis, jconf = setup["jout"]
    assert len(coords) == len(jcoords) == 2
    for a, b, tol in zip(coords, jcoords, (1e-4, 1e-3)):
        assert a.shape == (B, S, 6, 2)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=tol)
    # the query frame stays at the query points
    np.testing.assert_array_equal(coords[-1][:, 0].numpy(), setup["qp"])
    np.testing.assert_allclose(vis.numpy(), jvis, rtol=0, atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), jconf, rtol=0, atol=1e-5)


def test_track_predictor_gradient_matches_jax(setup):
    """d/d(fmaps, corr_mlp.fc1.w) of sum(coords[-1] * u) + sum(vis * v):
    the coordinates detached between iterations in both."""
    rng = np.random.default_rng(1)
    fm = rng.normal(size=(B, S, 14, 14, 16)).astype(np.float32)
    qp = rng.uniform(3, 25, size=(B, 5, 2)).astype(np.float32)
    u = rng.normal(size=(B, S, 5, 2)).astype(np.float32)
    v = rng.normal(size=(B, S, 5)).astype(np.float32)
    jcfg = setup["jcfg"]

    def jloss(w, f):
        p = {**setup["jp"], "corr_mlp": {**setup["jp"]["corr_mlp"],
                                         "fc1": {**setup["jp"]["corr_mlp"]["fc1"], "w": w}}}
        c, vis, _ = JH.track_predictor(p, jnp.asarray(qp), f, jcfg)
        return jnp.sum(c[-1] * u) + jnp.sum(vis * v)

    jw = setup["jp"]["corr_mlp"]["fc1"]["w"]
    jgw, jgf = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(jw), jnp.asarray(fm))

    tp = setup["tp"]
    w = tp["corr_mlp"]["fc1"]["w"].clone().requires_grad_(True)
    f = torch.from_numpy(fm).requires_grad_(True)
    p = {**tp, "corr_mlp": {**tp["corr_mlp"], "fc1": {**tp["corr_mlp"]["fc1"], "w": w}}}
    c, vis, _ = TH.track_predictor(p, torch.from_numpy(qp), f, setup["tcfg"])
    (torch.sum(c[-1] * torch.from_numpy(u)) + torch.sum(vis * torch.from_numpy(v))).backward()
    for got, want in ((w.grad, jgw), (f.grad, jgf)):
        want = np.asarray(want)
        assert float(np.abs(want).max()) > 0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(want).max()))


def test_init_matches_jax_structure(setup):
    """The port's init draws the tree the JAX package's has, at the same
    shapes; the default device is the card (without one, it raises)."""
    from tests.test_torch_converter import _with_paths

    tp = TH.init_track_head(torch.Generator().manual_seed(0), setup["tcfg"], device="cpu")
    got = [(p, tuple(t.shape)) for p, t in _with_paths(tp)]
    want = [(p, tuple(t.shape)) for p, t in _with_paths(setup["tp"])]
    assert got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TH.init_track_head(torch.Generator(), setup["tcfg"])
