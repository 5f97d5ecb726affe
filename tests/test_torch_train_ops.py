"""PyTorch port, training slice: the differentiable pieces of the train step.

The same numpy inputs go through the JAX package and the port:

- ``flash_bwd_plain`` (the plain version of the B9 dq and dk/dv kernels,
  which the port's backward runs on a CPU tensor) against the Pallas
  ``_flash_bwd`` in interpret mode, on ragged Nq / Nk, with and without an
  lse cotangent, under a ``RelocMask``, in fp32 and bf16;
- the gradients of every ``torch.autograd.Function`` on the path
  (``flash_attention_lse``, ``frame_ctx_attention``, the four fused block
  entries) against ``jax.vjp`` of the JAX entries (reference chains off the
  TPU);
- ``cdf_loss`` (values and the injected gradient), ``scene_loss`` (value,
  every metric, gradient), the loss geometry, and the Adam + schedule
  against optax.

Tolerances: fp32 atol 1e-5 or rtol 2e-4 (summation order; the port and JAX
reduce in other orders, and gradients of exp-scaled losses carry the
relative error of their inputs); bf16 within JAX's own bf16-vs-fp32
envelope (max |JAX-bf16 - JAX-fp32|), since the two round to bf16 at the
same points but sum in other orders.

Then the guards: every differentiable entry's output carries its Function
as ``grad_fn``, and every bare kernel wrapper raises under grad mode on an
input that requires grad (it would return a tensor with no ``grad_fn``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from self_supervise_sfm_tpu.ops import cdf_loss as JC
from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops import fused_qkv as JFQ
from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu.layers import rope as JR
from self_supervise_sfm_tpu.train import loss as JLo
from self_supervise_sfm_tpu.train import loop as JL
from self_supervise_sfm_tpu_torch.ops import cdf_loss as TC
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.ops import geometry as TG
from self_supervise_sfm_tpu_torch.ops import resize as TRS
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask
from self_supervise_sfm_tpu_torch.train import loop as TL
from self_supervise_sfm_tpu_torch.train import loss as TLo

torch.set_num_threads(1)

F32 = dict(rtol=2e-4, atol=1e-5)


def _np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(np.asarray(a, np.float32))).to(dtype)
    return t.requires_grad_() if grad else t


def _max_err(a, b):
    return float(np.abs(_np(a) - _np(b)).max())


def _jax_vjp(fn, args, cot, rest=()):
    """(fn(*args, *rest), its VJP in ``args`` at cotangent ``cot``), jitted:
    one compile instead of JAX's op-by-op dispatch."""

    def run(args, cot, rest):
        out, vjp = jax.vjp(lambda *a: fn(*a, *rest), *args)
        return out, vjp(cot)

    to = lambda x: jax.tree.map(jnp.asarray, x)  # noqa: E731
    return jax.jit(run)(to(tuple(args)), to(cot), to(tuple(rest)))


# -- B9: the flash backward ---------------------------------------------------

BWD_CASES = {
    # name: (Nq, Nk, lse cotangent, mask (n_ctx, frame_size, frames), dtype)
    "ragged": (130, 70, False, None, "float32"),
    "ragged_dlse": (130, 200, True, None, "float32"),
    "masked": (90, 130, False, (40, 45, 2), "float32"),
    "masked_dlse": (90, 130, True, (40, 45, 2), "float32"),
    "ragged_bf16": (130, 70, False, None, "bfloat16"),
    "masked_dlse_bf16": (90, 130, True, (40, 45, 2), "bfloat16"),
}
# head dim 128 (the backward of the 8-heads-of-128 train step): ragged Nq /
# Nk with an lse cotangent, and RelocMask(77, 130, 2), in fp32 and bf16
BWD_CASES_D128 = {
    "ragged_dlse": (130, 77, True, None, "float32"),
    "masked_dlse": (260, 337, True, (77, 130, 2), "float32"),
    "ragged_dlse_bf16": (130, 77, True, None, "bfloat16"),
    "masked_bf16": (260, 337, False, (77, 130, 2), "bfloat16"),
}


def _bwd_inputs(rng, nq, nk, dtype, d=64):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    q, do = (jnp.asarray(rng.normal(size=(2, nq, d)), jdt) for _ in range(2))
    k, v = (jnp.asarray(rng.normal(size=(2, nk, d)), jdt) for _ in range(2))
    return q, k, v, do


def _jax_bwd(q, k, v, do, dlse, mask):
    out, lse = JFA._flash_fwd(q, k, v, mask, 128, 128, True)
    return out, lse, JFA._flash_bwd(q, k, v, out, lse, do, mask, 128, 128, True, dlse=dlse)


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_flash_bwd_plain_matches_pallas_interpret(rng, case):
    """The plain backward on the Pallas forward's own out and lse, against
    the Pallas dq and dk/dv kernels (interpret mode, 128-row tiles, so the
    ragged last tiles and the masked tile skipping run). fp32: F32; bf16:
    within JAX's bf16-vs-fp32 envelope."""
    _check_plain_bwd(rng, *BWD_CASES[case])


@pytest.mark.parametrize("case", list(BWD_CASES_D128))
def test_flash_bwd_plain_matches_pallas_interpret_d128(rng, case):
    """The same at head dim 128 (``_flash_bwd`` with ``d=128``), at the head
    dim 64 cases' tolerances."""
    _check_plain_bwd(rng, *BWD_CASES_D128[case], d=128)


def _check_plain_bwd(rng, nq, nk, with_dlse, m, dtype, d=64):
    q, k, v, do = _bwd_inputs(rng, nq, nk, dtype, d)
    dlse = jnp.asarray(rng.normal(size=(2, nq)), jnp.float32) if with_dlse else None
    jmask = None if m is None else JRelocMask(*m)
    tmask = None if m is None else RelocMask(*m)
    out, lse, ref = _jax_bwd(q, k, v, do, dlse, jmask)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    port = TFA.flash_bwd_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(out, tdt), _t(lse),
                               _t(do, tdt), None if dlse is None else _t(dlse), tmask)
    # the CPU wrapper is the plain version
    wrapped = TFA.flash_bwd(_t(q, tdt), _t(k, tdt), _t(v, tdt), _t(out, tdt), _t(lse),
                            _t(do, tdt), None if dlse is None else _t(dlse), tmask)
    for a, b in zip(port, wrapped):
        assert torch.equal(a, b)
    if dtype == "float32":
        for name, a, b in zip(("dq", "dk", "dv"), port, ref):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(_np(a), _np(b), **F32, err_msg=name)
        return
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    _, _, ref32 = _jax_bwd(f32(q), f32(k), f32(v), f32(do), dlse, jmask)
    for name, a, b, c in zip(("dq", "dk", "dv"), port, ref, ref32):
        assert a.dtype == torch.bfloat16
        assert _max_err(a, b) <= _max_err(b, c), name


def test_flash_attention_lse_gradient_matches_jax_vjp(rng):
    """The port's Function (plain forward and backward on the CPU) against
    ``jax.vjp`` of JAX's ``flash_attention_lse`` (its custom_vjp over the
    Pallas kernels in interpret mode), cotangents on both out and lse."""
    q, k, v = (rng.normal(size=(1, 2, n, 64)).astype(np.float32) for n in (130, 70, 70))
    g_out = rng.normal(size=(1, 2, 130, 64)).astype(np.float32)
    g_lse = rng.normal(size=(1, 2, 130)).astype(np.float32)
    (o, lse), vjp = jax.vjp(JFA.flash_attention_lse, *map(jnp.asarray, (q, k, v)))
    ref = vjp((jnp.asarray(g_out), jnp.asarray(g_lse)))
    tq, tk, tv = (_t(x, grad=True) for x in (q, k, v))
    to, tlse = TFA.flash_attention_lse(tq, tk, tv)
    np.testing.assert_allclose(_np(to), _np(o), **F32)
    np.testing.assert_allclose(_np(tlse), _np(lse), **F32)
    port = torch.autograd.grad((to, tlse), (tq, tk, tv), (_t(g_out), _t(g_lse)))
    for name, a, b in zip(("dq", "dk", "dv"), port, ref):
        np.testing.assert_allclose(_np(a), _np(b), **F32, err_msg=name)


def test_frame_ctx_attention_gradient_matches_jax_vjp(rng):
    """K2's Function: backward by the own-frame + context flash split merged
    by lse (through the plain B9 on the CPU), context gradients summed over
    each scene's frames; against ``jax.vjp`` of JAX's
    ``frame_ctx_attention`` (the dense VJP off the TPU)."""
    q, k, v = (rng.normal(size=(4, 2, 20, 16)).astype(np.float32) for _ in range(3))
    ck, cv = (rng.normal(size=(2, 2, 12, 16)).astype(np.float32) for _ in range(2))
    g = rng.normal(size=(4, 2, 20, 16)).astype(np.float32)
    out, ref = _jax_vjp(JFA.frame_ctx_attention, (q, k, v, ck, cv), g)
    ts = [_t(x, grad=True) for x in (q, k, v, ck, cv)]
    tout = TFA.frame_ctx_attention(*ts)
    np.testing.assert_allclose(_np(tout), _np(out), **F32)
    port = torch.autograd.grad(tout, ts, _t(g))
    for name, a, b in zip(("dq", "dk", "dv", "dck", "dcv"), port, ref):
        np.testing.assert_allclose(_np(a), _np(b), **F32, err_msg=name)


# -- the fused block Functions ------------------------------------------------


def _fused_case(rng, which):
    """(jax entry, port entry, numpy args, static args) at B=2, N=24, C=128,
    4 heads of 32."""
    B, N, C, nh = 2, 24, 128, 4
    d = C // nh
    f = lambda *s, scale=1.0, loc=0.0: (loc + scale * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    x = f(B, N, C)
    ln = [f(C, scale=0.1, loc=1.0), f(C, scale=0.1)]
    if which == "ln_qkv_rope":
        cos, sin = (np.asarray(t) for t in JR.rope_tables(
            jnp.asarray(rng.uniform(0, 30, size=(N, 2)), jnp.float32), d))
        args = [x, *ln, f(C, 3 * C, scale=C**-0.5), f(3 * C, scale=0.1),
                f(d, scale=0.1, loc=1.0), f(d, scale=0.1), f(d, scale=0.1, loc=1.0),
                f(d, scale=0.1), cos, sin]
        return JFQ.fused_ln_qkv_rope, TFQ.fused_ln_qkv_rope, args, (nh, 1e-5)
    if which == "ln_qkv":
        args = [x, *ln, f(C, 3 * C, scale=C**-0.5), f(3 * C, scale=0.1)]
        return JFQ.fused_ln_qkv, TFQ.fused_ln_qkv, args, (nh, 1e-6)
    if which == "proj_residual":
        args = [f(B, nh, N, d), x, f(C, C, scale=C**-0.5), f(C, scale=0.1), f(C, scale=0.01)]
        return JFQ.fused_proj_residual, TFQ.fused_proj_residual, args, ()
    args = [x, *ln, f(C, 4 * C, scale=C**-0.5), f(4 * C, scale=0.1),
            f(4 * C, C, scale=(4 * C) ** -0.5), f(C, scale=0.1), f(C, scale=0.01)]
    return JFQ.fused_mlp_residual, TFQ.fused_mlp_residual, args, (1e-5,)


@pytest.mark.parametrize("which", ["ln_qkv_rope", "ln_qkv", "proj_residual", "mlp_residual"])
def test_fused_function_gradients_match_jax_vjp(rng, which):
    """Each fused Function's gradient in every tensor argument (the VJP of
    the recomputed plain chain) against ``jax.vjp`` of the JAX entry; fp32,
    F32."""
    jfn, tfn, args, static = _fused_case(rng, which)
    fn = lambda *a: jfn(*a, *static)  # noqa: E731
    shapes = jax.eval_shape(fn, *map(jnp.asarray, args))
    multi = isinstance(shapes, (tuple, list))
    gs = [rng.normal(size=o.shape).astype(np.float32)
          for o in (shapes if multi else (shapes,))]
    out, ref = _jax_vjp(fn, args, tuple(gs) if multi else gs[0])
    outs = out if multi else (out,)
    ts = [_t(a, grad=True) for a in args]
    tout = tfn(*ts, *static)
    touts = tout if isinstance(tout, tuple) else (tout,)
    for a, b in zip(touts, outs):
        np.testing.assert_allclose(_np(a), _np(b), **F32)
    port = torch.autograd.grad(touts, ts, [_t(g) for g in gs])
    for i, (a, b) in enumerate(zip(port, ref)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=2e-4, atol=2e-5,
                                   err_msg=f"{which}: argument {i}")


# -- the loss ------------------------------------------------------------------


def _cdf_inputs(rng, P=3, K=50):
    res = rng.uniform(0, 18, size=(P, K)).astype(np.float32)  # some past max_val
    w = (rng.uniform(size=(P, K)) > 0.2).astype(np.float32)
    return res, w, np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32)


@pytest.mark.parametrize("smooth", [0.05, 0.0])
def test_cdf_loss_values_and_injected_gradient_match_jax(rng, smooth):
    """CDF values (2.0 out of range), the per-frame pmf / cdf / pdf and the
    injected (pdf_src * g_src + pdf_dst * g_dst) * weight gradient; with
    the Gaussian smoothing and without (identity kernel). Histogram sums run
    in another order: F32."""
    res, w, src, dst = _cdf_inputs(rng)
    jcfg = JC.CDFLossConfig(0.0, 15.0, 50, 3, smooth)
    tcfg = TC.CDFLossConfig(0.0, 15.0, 50, 3, smooth)
    gs, gd = (rng.normal(size=res.shape).astype(np.float32) for _ in range(2))
    ja = [jnp.asarray(a) for a in (res, w, src, dst)]
    (cs, cd), (ref_g,) = _jax_vjp(lambda r, *rest: (JC.cdf_loss(r, *rest, jcfg)),
                                  (res,), (gs, gd), rest=ja[1:])
    tr = _t(res, grad=True)
    ta = [_t(a) for a in (w, src, dst)]
    tcs, tcd = TC.cdf_loss(tr, *ta, tcfg)
    np.testing.assert_allclose(_np(tcs), _np(cs), **F32)
    np.testing.assert_allclose(_np(tcd), _np(cd), **F32)
    assert float(tcs.detach().max()) == 2.0
    g = torch.autograd.grad((tcs, tcd), tr, (_t(gs), _t(gd)))[0]
    np.testing.assert_allclose(_np(g), _np(ref_g), **F32)
    jst = JC.frame_statistics(*ja, jcfg)
    tst = TC.frame_statistics(torch.from_numpy(res), *ta, tcfg)
    for key in ("frame_pmf", "frame_cdf", "frame_pdf"):
        np.testing.assert_allclose(_np(tst[key]), _np(jst[key]), **F32, err_msg=key)


def test_reflect_correlate_matches_jax(rng):
    """Reflect padding without repeating the edge sample, as ``jnp.pad``."""
    rows = rng.normal(size=(3, 20)).astype(np.float32)
    for K in (1, 3, 7):
        kern = rng.normal(size=(K,)).astype(np.float32)
        ref = JC._reflect_correlate(jnp.asarray(rows), jnp.asarray(kern))
        got = TC._reflect_correlate(torch.from_numpy(rows), torch.from_numpy(kern))
        np.testing.assert_allclose(_np(got), _np(ref), **F32)


def _scene(rng, P=3, K=40, S=3):
    """One scene's loss inputs: poses near identity, correspondences in a
    64 x 48 image, one padded (invalid) pair."""
    E = np.concatenate([np.eye(3)[None].repeat(S, 0) + 0.05 * rng.normal(size=(S, 3, 3)),
                        0.3 * rng.normal(size=(S, 3, 1))], -1).astype(np.float32)
    Kp = np.array([[40.0, 0, 14], [0, 40.0, 14], [0, 0, 1]], np.float32)[None].repeat(S, 0)
    scene = {
        "K_prime_to_K": np.broadcast_to(np.diag([64 / 28, 48 / 28, 1.0]),
                                        (S, 3, 3)).astype(np.float32),
        "src_idx": np.array([0, 1, 2], np.int32), "dst_idx": np.array([1, 2, 0], np.int32),
        "src_coords": rng.uniform(0, 48, size=(P, K, 2)).astype(np.float32),
        "dst_coords": rng.uniform(0, 48, size=(P, K, 2)).astype(np.float32),
        "src_depth": rng.uniform(1, 5, size=(P, K)).astype(np.float32),
        "dst_depth": rng.uniform(1, 5, size=(P, K)).astype(np.float32),
        "pair_valid": np.array([1.0, 1.0, 0.0], np.float32),
    }
    return E, Kp, scene


@pytest.mark.parametrize("shared_focal", [False, True])
def test_scene_loss_value_metrics_and_gradient_match_jax(rng, shared_focal):
    """``scene_loss``: the loss, every metric (the p10 / p50 / p90 of
    ``torch.nanquantile`` against ``jnp.nanpercentile``, both linear) and
    the gradient in the predicted extrinsics and intrinsics. F32, rtol 1e-4
    on the pixel-scale residual mean."""
    E, Kp, scene = _scene(rng)
    jcfg = JLo.LossConfig(num_bins=50, shared_focal=shared_focal)
    tcfg = TLo.LossConfig(num_bins=50, shared_focal=shared_focal)
    js = {k: jnp.asarray(v) for k, v in scene.items()}
    (loss, m), g = jax.jit(jax.value_and_grad(
        lambda e, k, js: JLo.scene_loss(e, k, js, jcfg), argnums=(0, 1), has_aux=True))(
        jnp.asarray(E), jnp.asarray(Kp), js)
    ts = {k: torch.from_numpy(v) for k, v in scene.items()}
    te, tk = _t(E, grad=True), _t(Kp, grad=True)
    tloss, tm = TLo.scene_loss(te, tk, ts, tcfg)
    np.testing.assert_allclose(_np(tloss), _np(loss), atol=1e-5)
    assert set(tm) == set(m)
    for key in m:
        np.testing.assert_allclose(_np(tm[key]), _np(m[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    tg = torch.autograd.grad(tloss, (te, tk))
    for a, b in zip(tg, g):
        np.testing.assert_allclose(_np(a), _np(b), **F32)


def test_loss_geometry_matches_jax(rng):
    """``relative_pose``, both reprojections, the residual and the
    homogeneous helpers, in fp32 (TF32 off)."""
    E, Kp, scene = _scene(rng)
    src, dst = scene["src_idx"], scene["dst_idx"]
    rel = JG.relative_pose(jnp.asarray(E[src]), jnp.asarray(E[dst]))
    trel = TG.relative_pose(_t(E[src]), _t(E[dst]))
    np.testing.assert_allclose(_np(trel), _np(rel), **F32)
    ones = np.ones((3, 1), np.float32)
    args = (scene["src_coords"], scene["src_depth"], Kp[src], Kp[dst])
    a, _ = JG.backproject_and_reproject(*map(jnp.asarray, args), rel, jnp.asarray(ones))
    ta, valid = TG.backproject_and_reproject(*map(_t, args), trel, _t(ones))
    np.testing.assert_allclose(_np(ta), _np(a), **F32)
    assert bool(valid.all())
    aargs = (scene["src_coords"], scene["src_depth"], scene["dst_depth"], Kp[src], Kp[dst])
    b, _ = JG.backproject_and_reproject_with_approximation(
        *map(jnp.asarray, aargs), rel, jnp.asarray(ones), jnp.asarray(ones))
    tb, _ = TG.backproject_and_reproject_with_approximation(
        *map(_t, aargs), trel, _t(ones), _t(ones))
    np.testing.assert_allclose(_np(tb), _np(b), **F32)
    r = JG.compute_projective_residual(a, jnp.asarray(scene["dst_coords"]))
    tr = TG.compute_projective_residual(ta, _t(scene["dst_coords"]))
    np.testing.assert_allclose(_np(tr), _np(r), **F32)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    pts[0, -1] = -1e-6  # the exact-zero guard of the divide
    np.testing.assert_allclose(_np(TG.to_homogeneous(_t(pts))),
                               _np(JG.to_homogeneous(jnp.asarray(pts))))
    np.testing.assert_allclose(_np(TG.from_homogeneous(_t(pts))),
                               _np(JG.from_homogeneous(jnp.asarray(pts))), **F32)


# -- the optimizer -------------------------------------------------------------


@pytest.mark.parametrize("warmup,total", [(3, 10), (20, 10)])
def test_schedule_matches_optax(warmup, total):
    """Linear warmup from 0 and cosine decay, warmup clamped to total."""
    jcfg = JL.TrainConfig(max_lr=2e-4, warmup_steps=warmup, total_steps=total)
    tcfg = TL.TrainConfig(max_lr=2e-4, warmup_steps=warmup, total_steps=total)
    js, ts = JL.make_schedule(jcfg), TL.make_schedule(tcfg)
    for step in range(0, 25):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12), step
    assert ts(0) == 0.0


@pytest.mark.parametrize("mu_dtype,clip", [("float32", 0.0), ("bfloat16", 0.0),
                                           ("float32", 1.0)])
def test_adam_matches_optax(rng, mu_dtype, clip):
    """Four updates of random trees through the port's Adam (optionally
    after global-norm clipping) against optax's chain, jitted as in the JAX
    train step; params, mu and nu after every update. Same operations in the
    same order with fp32 bias corrections, but XLA contracts the fused
    update into FMAs and sums the clipping norm in another order: moments
    within 4 fp32 ulps of their largest magnitude (bf16 mu: one bf16 ulp),
    parameters (|p| <= 4, moved by ~lr = 1e-3) within atol 1e-6, where a
    last-bit difference in the update can flip the rounding of p + u."""
    shapes = [(7, 5), (13,), (3, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    cfg = JL.TrainConfig(max_lr=1e-3, warmup_steps=2, total_steps=10,
                         adam_mu_dtype=mu_dtype, grad_clip_norm=clip)
    opt = JL.make_optimizer(cfg)
    update = jax.jit(opt.update)  # as in the jitted train step
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    tcfg = TL.TrainConfig(max_lr=1e-3, warmup_steps=2, total_steps=10,
                          adam_mu_dtype=mu_dtype, grad_clip_norm=clip)
    tstate = TL.train_state_from_params([torch.from_numpy(p.copy()) for p in params], tcfg)
    sched = TL.make_schedule(tcfg)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[mu_dtype]
    for i in range(4):
        grads = [rng.normal(scale=2.0, size=s).astype(np.float32) for s in shapes]
        upd, js = update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g) for g in grads]
        if clip > 0:
            tg = TL.clip_by_global_norm(tg, clip)
        op = tstate["opt"]
        TL.adam_update(tstate["params"], tg, op["mu"], op["nu"], op["count"], sched(i))
        op["count"] += 1
        adam = [s for s in jax.tree.leaves(js, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")][0]
        for a, b in zip(tstate["params"], jp):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-6)
        mu_ulps = 4 * 2.0**-23 if mu_dtype == "float32" else 2.0**-8
        for a, b in zip(op["mu"], adam.mu):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=mu_ulps * np.abs(_np(b)).max())
        for a, b in zip(op["nu"], adam.nu):
            np.testing.assert_allclose(_np(a), _np(b), rtol=0,
                                       atol=4 * 2.0**-23 * np.abs(_np(b)).max())


def test_train_entry_points_default_to_cuda(monkeypatch):
    """Without a card the train entry points raise, not run on the CPU."""
    from self_supervise_sfm_tpu_torch.models import sailrecon as TM

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.make_config(img_size=28, embed_dim=64, depth=2, num_heads=4, vit_depth=1,
                         intermediate_layer_idx=(0, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.make_train_step(cfg, TL.TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.init_train_state(cfg, TL.TrainConfig(), torch.Generator().manual_seed(0))


# -- no silent graph cut ---------------------------------------------------------


def _entries(rng):
    """(name, differentiable call, its Function) over requires-grad inputs."""
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_()  # noqa: E731
    q, k, v = r(1, 2, 20, 16), r(1, 2, 20, 16), r(1, 2, 20, 16)
    fq, fk, fv, ck, cv = r(2, 2, 9, 16), r(2, 2, 9, 16), r(2, 2, 9, 16), r(1, 2, 5, 16), r(1, 2, 5, 16)
    mask = RelocMask(n_ctx=4, frame_size=8, num_frames=2)
    qm, km, vm = r(1, 2, 16, 16), r(1, 2, 20, 16), r(1, 2, 20, 16)
    fused = {w: _fused_case(rng, w) for w in ("ln_qkv_rope", "ln_qkv", "proj_residual",
                                              "mlp_residual")}

    def fused_call(w):
        _, fn, args, static = fused[w]
        return lambda: fn(*[_t(a, grad=True) for a in args], *static)

    x, add = r(1, 4, 5, 4), r(7, 9, 4)
    return [
        ("flash_attention", lambda: TFA.flash_attention(q, k, v), TFA._FlashAttention),
        ("flash_attention[mask]", lambda: TFA.flash_attention(qm, km, vm, mask),
         TFA._FlashAttention),
        ("flash_attention_lse", lambda: TFA.flash_attention_lse(q, k, v),
         TFA._FlashAttentionLse),
        ("frame_ctx_attention", lambda: TFA.frame_ctx_attention(fq, fk, fv, ck, cv),
         TFA._FrameCtxAttention),
        ("fused_ln_qkv_rope", fused_call("ln_qkv_rope"), TFQ._LnQkvRope),
        ("fused_ln_qkv", fused_call("ln_qkv"), TFQ._LnQkv),
        ("fused_proj_residual", fused_call("proj_residual"), TFQ._ProjResidual),
        ("fused_mlp_residual", fused_call("mlp_residual"), TFQ._MlpResidual),
        ("resize_bilinear", lambda: TRS.resize_bilinear(x, (7, 9), add), TRS._ResizeBilinear),
    ]


def test_differentiable_entries_go_through_their_function(rng):
    for name, call, fn in _entries(rng):
        outs = call()
        for out in (outs if isinstance(outs, tuple) else (outs,)):
            assert type(out.grad_fn).__name__ == fn.__name__ + "Backward", name


def test_bare_kernel_wrappers_refuse_inputs_that_require_grad(rng):
    """Under grad mode a bare launch wrapper raises on an input that
    requires grad, on every device (here the CPU); under no_grad, or on
    inputs that need no grad, it runs."""
    r = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q, k, v = r(2, 20, 16), r(2, 20, 16), r(2, 20, 16)
    fq, ck, ckv = r(2, 2, 9, 16), r(1, 2, 5, 16), r(3, 1, 2, 5, 32)
    mask = RelocMask(n_ctx=4, frame_size=8, num_frames=2)
    qm, km = r(2, 16, 16), r(2, 20, 16)
    x, add = r(1, 4, 5, 4), r(7, 9, 4)
    _, _, a_rope, s_rope = _fused_case(rng, "ln_qkv_rope")
    _, _, a_qkv, s_qkv = _fused_case(rng, "ln_qkv")
    _, _, a_proj, _ = _fused_case(rng, "proj_residual")
    _, _, a_mlp, _ = _fused_case(rng, "mlp_residual")
    h = r(2, 24, 512)
    bare = [
        ("flash_fwd", TFA.flash_fwd, [q, k, v], ()),
        ("flash_fwd_reloc", TFA.flash_fwd_reloc, [qm, km, km], (mask,)),
        ("frame_ctx_fwd", TFA.frame_ctx_fwd, [fq, fq, fq, ck, ck], ()),
        ("frame_ctx_packed_fwd", TFA.frame_ctx_packed_fwd, [fq, fq, fq, ckv], (1,)),
        ("fused_ln_qkv_rope_fwd", TFQ.fused_ln_qkv_rope_fwd,
         [_t(a) for a in a_rope], s_rope),
        ("fused_ln_qkv_fwd", TFQ.fused_ln_qkv_fwd, [_t(a) for a in a_qkv], s_qkv),
        ("fused_proj_residual_fwd", TFQ.fused_proj_residual_fwd,
         [_t(a) for a in a_proj], ()),
        ("fused_mlp_up", TFQ.fused_mlp_up, [_t(a) for a in a_mlp[:5]], ()),
        ("fused_mlp_down", TFQ.fused_mlp_down,
         [h, _t(a_mlp[0])] + [_t(a) for a in a_mlp[5:]], ()),
        ("resize_bilinear_fwd", TRS.resize_bilinear_fwd, [x], ((7, 9), add)),
    ]
    for name, fn, tensors, extra in bare:
        fn(*tensors, *extra)  # nothing requires grad: runs
        grad_in = [tensors[0].clone().requires_grad_()] + tensors[1:]
        with pytest.raises(NotImplementedError):
            fn(*grad_in, *extra)
        with torch.no_grad():
            fn(*grad_in, *extra)
