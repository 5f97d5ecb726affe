"""PyTorch port: params, rope, attention, block, ViT and geometry vs the JAX
package, on the same numpy weights and inputs (fp32 unless stated)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import block as JB
from self_supervise_sfm_tpu.layers import params as JP
from self_supervise_sfm_tpu.layers import rope as JR
from self_supervise_sfm_tpu.layers import vit as JV
from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.layers import params as TP
from self_supervise_sfm_tpu_torch.layers import rope as TR
from self_supervise_sfm_tpu_torch.layers import vit as TV
from self_supervise_sfm_tpu_torch.ops import geometry as TG

torch.set_num_threads(1)

ATOL = 2e-5  # fp32, summation order only


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _port(tree):
    """JAX param subtree -> the port's layout (unstacked, OIHW convs)."""
    return convert.from_jax_params(jax.tree.map(np.asarray, tree))


def _rand_params(rng, init_fn):
    """numpy params in the structure ``init_fn`` builds (traced abstractly,
    so no JAX random kernels compile): fan-in scaled weights, non-trivial
    norms, biases and layer-scales."""
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.normal(size=s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if len(s.shape) >= 2 and name == "w":
            return x / np.sqrt(np.prod(s.shape[:-1]))
        return 0.1 * x
    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


# -- params -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_and_layer_norm(rng, dtype):
    x = rng.normal(size=(3, 7, 24)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    lin = _rand_params(rng, lambda: JP.init_linear(jax.random.PRNGKey(1), 24, 40))
    ln = {"scale": jnp.asarray(rng.normal(size=24).astype(np.float32)),
          "bias": jnp.asarray(rng.normal(size=24).astype(np.float32))}
    tol = ATOL if dtype == "float32" else 0.05  # one bf16 rounding at |y| ~ 4
    for jf, tf, p in ((JP.linear, TP.linear, lin), (JP.layer_norm, TP.layer_norm, ln)):
        j = jf(p, jx)
        t = tf(_port(p), tx)
        assert t.dtype == tx.dtype
        np.testing.assert_allclose(_np(t), _np(j), atol=tol, rtol=tol)


@pytest.mark.parametrize("kh,stride,padding", [
    (3, 1, "SAME"), (1, 1, "SAME"), (14, 14, "VALID"), (3, 2, [(1, 1), (1, 1)]),
])
def test_conv2d(rng, kh, stride, padding):
    x = rng.normal(size=(2, 28, 28, 6)).astype(np.float32)
    p = _rand_params(rng, lambda: JP.init_conv(jax.random.PRNGKey(2), kh, kh, 6, 10))
    j = jax.jit(lambda p, x: JP.conv2d(p, x, stride=stride, padding=padding))(
        p, jnp.asarray(x))
    t = TP.conv2d(_port(p), _t(x), stride=stride, padding=padding)
    np.testing.assert_allclose(_np(t), _np(j), atol=1e-4)


def test_conv2d_bf16_input_fp32_accumulation(rng):
    x = rng.normal(size=(2, 9, 9, 8)).astype(np.float32)
    p = _rand_params(rng, lambda: JP.init_conv(jax.random.PRNGKey(3), 3, 3, 8, 4))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    j = jax.jit(lambda p, x: JP.conv2d(p, x, accum_dtype=jnp.float32))(p, jx)
    t = TP.conv2d(_port(p), _t(_np(jx)).to(torch.bfloat16), accum_dtype=torch.float32)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(_np(t), _np(j), atol=1e-4)


@pytest.mark.parametrize("k", [2, 4])
def test_conv_transpose2d(rng, k):
    x = rng.normal(size=(2, 5, 6, 8)).astype(np.float32)
    p = _rand_params(rng, lambda: JP.init_conv_transpose(jax.random.PRNGKey(4), k, k, 8, 12))
    j = jax.jit(lambda p, x: JP.conv_transpose2d(p, x, k))(p, jnp.asarray(x))
    t = TP.conv_transpose2d(_port(p), _t(x), k)
    np.testing.assert_allclose(_np(t), _np(j), atol=1e-4)


def test_gelu_and_layer_scale(rng):
    x = rng.normal(size=(4, 33)).astype(np.float32) * 3
    g = {"gamma": jnp.asarray(rng.normal(size=33).astype(np.float32))}
    np.testing.assert_allclose(_np(TP.gelu(_t(x))), _np(JP.gelu(jnp.asarray(x))), atol=1e-6)
    np.testing.assert_allclose(_np(TP.layer_scale(_port(g), _t(x))),
                               _np(JP.layer_scale(g, jnp.asarray(x))), atol=1e-6)


# -- rope ---------------------------------------------------------------------


def test_rope(rng):
    pos = JR.position_grid(3, 5) + 1
    np.testing.assert_array_equal(_np(TR.position_grid(3, 5) + 1), _np(pos))
    jc, js = JR.rope_tables(pos, 16)
    tc, ts = TR.rope_tables(_t(np.asarray(pos)), 16)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-6)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-6)
    x = rng.normal(size=(2, 3, 15, 16)).astype(np.float32)
    for tab_j, tab_t in (((jc, js), (tc, ts)), ((jc[None], js[None]), (tc[None], ts[None]))):
        np.testing.assert_allclose(_np(TR.apply_rope(_t(x), *tab_t)),
                                   _np(JR.apply_rope(jnp.asarray(x), *tab_j)), atol=1e-5)


# -- block --------------------------------------------------------------------


def _block_setup(rng, qk_norm, impl="auto"):
    jcfg = JB.BlockConfig(dim=32, num_heads=4, qk_norm=qk_norm, attn_impl=impl)
    tcfg = TB.BlockConfig(dim=32, num_heads=4, qk_norm=qk_norm, attn_impl=impl)
    p = _rand_params(rng, lambda: JB.init_block(jax.random.PRNGKey(5), jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), _port(p)


def _tabs(n, hd, batch=None):
    pos = JR.position_grid(1, n)
    jt = JR.rope_tables(pos, hd)
    if batch:
        jt = tuple(jnp.broadcast_to(a[None], (batch,) + a.shape) for a in jt)
    return jt, tuple(_t(np.asarray(a)) for a in jt)


@pytest.mark.parametrize("qk_norm,rope,impl", [
    (False, False, "auto"), (True, True, "auto"), (True, True, "flash"),
])
def test_block(rng, qk_norm, rope, impl):
    jcfg, tcfg, jp, tp = _block_setup(rng, qk_norm, impl)
    x = rng.normal(size=(3, 11, 32)).astype(np.float32)
    jt, tt = _tabs(11, 8) if rope else (None, None)
    j = jax.jit(JB.block, static_argnums=2)(jp, jnp.asarray(x), jcfg, jt)
    t = TB.block(tp, _t(x), tcfg, tt)
    np.testing.assert_allclose(_np(t), _np(j), atol=ATOL)
    jq = JB.qkv_parts(jp, jnp.asarray(x), jcfg, jt)
    tq = TB.qkv_parts(tp, _t(x), tcfg, tt)
    for a, b in zip(tq, jq):
        np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    np.testing.assert_allclose(_np(TB.attn_out_mlp(tp, tq[0], _t(x), tcfg)),
                               _np(JB.attn_out_mlp(jp, jq[0], jnp.asarray(x), jcfg)),
                               atol=ATOL)


@pytest.mark.parametrize("frames,impl", [(1, "auto"), (3, "auto"), (3, "flash")])
def test_block_with_context(rng, frames, impl):
    """frames == 1: [ctx ‖ x] concatenation through sdpa; frames > 1: the
    frame-major [ctx ‖ own frame] layout (the K2 site)."""
    jcfg, tcfg, jp, tp = _block_setup(rng, True, impl)
    B, P, nc = 2, 9, 13
    x = rng.normal(size=(B * frames, P, 32)).astype(np.float32)
    ctx = rng.normal(size=(B, nc, 32)).astype(np.float32)
    jq, tq = _tabs(P, 8)
    jc, tc = _tabs(nc, 8, batch=B)
    j = jax.jit(JB.block_with_context, static_argnums=3)(
        jp, jnp.asarray(x), jnp.asarray(ctx), jcfg, jq, jc)
    t = TB.block_with_context(tp, _t(x), _t(ctx), tcfg, tq, tc)
    np.testing.assert_allclose(_np(t), _np(j), atol=ATOL)


def test_block_mask_matches_jax(rng):
    jcfg, tcfg, jp, tp = _block_setup(rng, False)
    x = rng.normal(size=(2, 6, 32)).astype(np.float32)
    mask = np.tril(np.ones((6, 6), bool))[None, None]
    j = jax.jit(JB.block, static_argnums=2)(jp, jnp.asarray(x), jcfg, None,
                                             jnp.asarray(mask))
    t = TB.block(tp, _t(x), tcfg, mask=_t(mask))
    np.testing.assert_allclose(_np(t), _np(j), atol=ATOL)


@pytest.mark.parametrize("name", ["fused_qkv", "fused_mlp"])
@pytest.mark.parametrize("value", ["auto", "on", "off"])
def test_fused_switches_are_tri_state(name, value):
    cfg = TB.BlockConfig(dim=8, num_heads=2, **{name: value})
    assert getattr(cfg, name) == value
    assert TB.BlockConfig(dim=8, num_heads=2).fused_qkv == "auto"
    with pytest.raises(ValueError, match=name):
        TB.BlockConfig(dim=8, num_heads=2, **{name: "maybe"})


# -- ViT ----------------------------------------------------------------------


@pytest.mark.parametrize("img", [28, 42])
def test_vit_forward(rng, img):
    """img 28: the native grid; img 42: pos-embed interpolation 2x2 -> 3x3."""
    jcfg = JV.ViTConfig(img_size=28, embed_dim=32, depth=2, num_heads=4)
    tcfg = TV.ViTConfig(img_size=28, embed_dim=32, depth=2, num_heads=4)
    jp = _rand_params(rng, lambda: JV.init_vit(jax.random.PRNGKey(6), jcfg))
    x = rng.normal(size=(2, img, img, 3)).astype(np.float32)
    j = jax.jit(JV.vit_forward, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    t = TV.vit_forward(_port(jp), _t(x), tcfg)
    for k in j:
        np.testing.assert_allclose(_np(t[k]), _np(j[k]), atol=1e-4, err_msg=k)


def test_vit_interp_matrix():
    for n_out, n_in in ((3, 2), (37, 11), (11, 37), (5, 5)):
        np.testing.assert_array_equal(TV._interp_matrix(n_out, n_in),
                                      JV._interp_matrix(n_out, n_in))


# -- geometry -----------------------------------------------------------------


def test_pose_decode_and_unprojection(rng):
    enc = rng.normal(size=(2, 3, 9)).astype(np.float32)
    enc[..., 7:] = np.abs(enc[..., 7:]) + 0.3
    je, ji = jax.jit(lambda e: JG.pose_encoding_to_extri_intri(e, (28, 42)))(
        jnp.asarray(enc))
    te, ti = TG.pose_encoding_to_extri_intri(_t(enc), (28, 42))
    np.testing.assert_allclose(_np(te), _np(je), atol=1e-5)
    np.testing.assert_allclose(_np(ti), _np(ji), rtol=1e-6)
    depth = rng.uniform(0.5, 3.0, size=(2, 3, 28, 42, 1)).astype(np.float32)
    jw = jax.jit(JG.unproject_depth_to_world)(jnp.asarray(depth), je, ji)
    tw = TG.unproject_depth_to_world(_t(depth), te, ti)
    np.testing.assert_allclose(_np(tw), _np(jw), atol=1e-4, rtol=1e-5)
    jc = jax.jit(JG.depth_to_cam_points)(jnp.asarray(depth[..., 0]), ji)
    tc = TG.depth_to_cam_points(_t(depth[..., 0]), ti)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-5)


def test_block_config_fields_mirror_jax():
    jf = {f.name for f in dataclasses.fields(JB.BlockConfig)}
    assert jf == {f.name for f in dataclasses.fields(TB.BlockConfig)}
