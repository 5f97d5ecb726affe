"""PyTorch port, the layer forms that no main path runs, against the JAX
package (fp32): the ViT widths (``vit_small`` / ``vit_base`` /
``vit_giant2``), SwiGLU, the block's stochastic depth given the masks JAX
drew (torch cannot replay ``jax.random``), and the pose decode without
intrinsics. Then the fused-block "auto" gates on ``device="meta"``
tensors, with ``_kernels.launch`` recorded in place of a build: a width
the fused kernels do not take routes that site to the plain chain under
"auto" and meets the kernel's refusal under "on"; widths they take reach
the kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import block as JB
from self_supervise_sfm_tpu.layers import swiglu as JS
from self_supervise_sfm_tpu.layers import vit as JV
from self_supervise_sfm_tpu.ops import geometry as JG
from self_supervise_sfm_tpu_torch import _kernels as TK
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.layers import swiglu as TS
from self_supervise_sfm_tpu_torch.layers import vit as TV
from self_supervise_sfm_tpu_torch.ops import geometry as TG
from tests.test_torch_converter import random_params

torch.set_num_threads(1)

ATOL = 2e-5  # fp32, summation order only


@pytest.mark.parametrize("name", ["vit_small", "vit_base", "vit_large", "vit_giant2"])
def test_vit_variant_configs_equal_jax(name):
    j, t = getattr(JV, name)(), getattr(TV, name)()
    shared = {f.name for f in dataclasses.fields(j)} & {f.name for f in dataclasses.fields(t)}
    assert {"embed_dim", "depth", "num_heads", "mlp_ratio", "patch_size"} <= shared
    for f in shared:
        assert getattr(t, f) == getattr(j, f), f
    assert t.block_cfg.dim // t.block_cfg.num_heads == 64


def test_swiglu_matches_jax(rng):
    assert [TS.swiglu_hidden_fused(h) for h in (4096, 6144, 100)] == [
        JS.swiglu_hidden_fused(h) for h in (4096, 6144, 100)]
    hidden = TS.swiglu_hidden_fused(4 * 48)
    jp = random_params(lambda: JS.init_swiglu(jax.random.PRNGKey(0), 48, hidden))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tp = TS.init_swiglu(torch.Generator().manual_seed(0), "cpu", 48, hidden)
    assert {k: {n: tuple(v.shape) for n, v in d.items()} for k, d in tp.items()} == shapes
    x = rng.normal(size=(3, 5, 48)).astype(np.float32)
    want = JS.swiglu(jp, jnp.asarray(x))
    got = TS.swiglu(convert.from_jax_params(jp), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)


def test_block_drop_path_matches_jax_given_its_masks(rng, monkeypatch):
    cfg_j = JB.BlockConfig(dim=32, num_heads=4, attn_impl="dense", drop_path=0.5)
    cfg_t = TB.BlockConfig(dim=32, num_heads=4, attn_impl="dense", drop_path=0.5)
    jp = random_params(lambda: JB.init_block(jax.random.PRNGKey(1), cfg_j))
    x = rng.normal(size=(16, 7, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JB.block(jp, jnp.asarray(x), cfg_j, drop_key=key)
    # the two masks JAX drew (one key a branch; each depends on x's shape alone)
    masks = [np.asarray(JB.drop_path_mask(k, jnp.asarray(x), 0.5))
             for k in jax.random.split(key)]
    assert {0.0, 2.0} == set(np.unique(np.concatenate(masks)))
    feed = iter(torch.from_numpy(m.copy()) for m in masks)
    drawn = []
    monkeypatch.setattr(TB, "drop_path_mask",
                        lambda g, t, rate: drawn.append((g, t.shape, rate)) or next(feed))
    gen = torch.Generator().manual_seed(0)
    got = TB.block(convert.from_jax_params(jp), torch.from_numpy(x), cfg_t, drop_generator=gen)
    assert [d[1:] for d in drawn] == [(x.shape, 0.5)] * 2 and drawn[0][0] is gen
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    # no generator (evaluation) or a zero rate: the plain block
    plain = TB.block(convert.from_jax_params(jp), torch.from_numpy(x), cfg_t)
    np.testing.assert_allclose(plain.numpy(), np.asarray(JB.block(jp, jnp.asarray(x), cfg_j)),
                               rtol=ATOL, atol=ATOL)


def test_drop_path_mask_semantics():
    """Per-sample Bernoulli(keep) scaled by 1 / keep, broadcast over the rest,
    unbiased; one generator state gives one mask, and two draws differ."""
    x = torch.zeros((4096, 3, 8))
    g = torch.Generator().manual_seed(0)
    m1, m2 = TB.drop_path_mask(g, x, 0.3), TB.drop_path_mask(g, x, 0.3)
    assert m1.shape == (4096, 1, 1) and m1.dtype == x.dtype
    np.testing.assert_allclose(sorted(np.unique(m1.numpy())), [0.0, 1.0 / 0.7], rtol=1e-6)
    assert abs(float(m1.mean()) - 1.0) < 0.05 and not torch.equal(m1, m2)
    assert torch.equal(m1, TB.drop_path_mask(torch.Generator().manual_seed(0), x, 0.3))


def test_pose_decode_without_intrinsics_matches_jax(rng):
    enc = rng.normal(size=(2, 3, 9)).astype(np.float32)
    jext, jint = JG.pose_encoding_to_extri_intri(jnp.asarray(enc), build_intrinsics=False)
    text, tint = TG.pose_encoding_to_extri_intri(torch.from_numpy(enc), build_intrinsics=False)
    assert jint is None and tint is None
    np.testing.assert_allclose(text.numpy(), np.asarray(jext), rtol=ATOL, atol=ATOL)
    ext, _ = TG.pose_encoding_to_extri_intri(torch.from_numpy(enc), (28, 42))
    assert torch.equal(ext, text)
    with pytest.raises(ValueError, match="image_size_hw"):
        TG.pose_encoding_to_extri_intri(torch.from_numpy(enc))


# -- the fused-block "auto" gates on the card (meta tensors) ----------------------------

N = 1374  # a 518 px frame's tokens
FLASH, QKV_ROPE, QKV = "sfm_flash_fwd_bf16", "sfm_ln_qkv_rope_sm90", "sfm_ln_qkv_sm90"
PROJ, UP, DOWN = "sfm_proj_residual_sm90", "sfm_mlp_up_sm90", "sfm_mlp_down_sm90"
# the head dim 128 forms
FLASH_D128, QKV_ROPE_D128 = "sfm_flash_fwd_d128_bf16", "sfm_ln_qkv_rope_d128_sm90"
QKV_D128, PROJ_D128 = "sfm_ln_qkv_d128_sm90", "sfm_proj_residual_d128_sm90"


@pytest.fixture
def launches(monkeypatch):
    seen = []
    monkeypatch.setattr(TK, "launch", lambda name, *args: seen.append(name))
    monkeypatch.setattr(TK, "stream_ptr", lambda t: 0)
    return seen


def _meta_block(C, heads, form, mode, device="meta", dtype=torch.bfloat16):
    """One block at (C, heads) in ``dtype`` (bf16: the trunk's weights cast),
    and its call: a frame block (qk-norm, 2D rope) or a ViT block (neither)."""
    cfg = TB.BlockConfig(dim=C, num_heads=heads, qk_norm=form == "frame", fused_qkv=mode,
                         fused_mlp=mode)
    p = TB.init_block(None, device, cfg)
    for sub in (p["attn"]["qkv"], p["attn"]["proj"], p["mlp"]["fc1"], p["mlp"]["fc2"]):
        sub["w"] = sub["w"].to(dtype)
    x = torch.empty((2, N, C), dtype=dtype, device=device)
    d = C // heads
    rope = (tuple(torch.empty((N, d), device=device) for _ in range(2))
            if form == "frame" else None)
    return lambda: TB.block(p, x, cfg, rope)


# (C, heads) -> the kernels of a frame block under "auto" (the ViT block
# the same with LN+QKV in place of LN+QKV+RoPE): head dim 64 with an even
# head count, or head dim 128, takes every kernel at C a multiple of 128
# (1024 / 8 on the head dim 128 forms); head dim 32 or 96 takes the MLP
# pair alone (no head condition) and routes attention dense; an odd head
# count of 64 takes K1 alone, since LN+QKV(+RoPE) needs an even count and
# the out-projection and the MLP pair a C that is a multiple of 128
ALL = [QKV_ROPE, FLASH, PROJ, UP, DOWN]
TAKEN = {(1024, 16): ALL,
         (768, 12): ALL,
         (1536, 24): ALL,
         (1024, 8): [QKV_ROPE_D128, FLASH_D128, PROJ_D128, UP, DOWN],
         (640, 10): ALL,
         (384, 6): ALL,
         (1024, 32): [UP, DOWN],
         (320, 5): [FLASH],
         (384, 4): [UP, DOWN]}


@pytest.mark.parametrize("form", ["frame", "vit"])
@pytest.mark.parametrize("C,heads", list(TAKEN))
def test_auto_routes_widths_the_fused_kernels_do_not_take_plain(launches, C, heads, form):
    out = _meta_block(C, heads, form, "auto")()
    vit = {QKV_ROPE: QKV, QKV_ROPE_D128: QKV_D128} if form == "vit" else {}
    want = [vit.get(n, n) for n in TAKEN[(C, heads)]]
    assert launches == want
    assert out.shape == (2, N, C) and out.dtype == torch.bfloat16 and out.device.type == "meta"


# widths LN+QKV(+RoPE) refuses: head dim 32 and 96, an odd head count of
# 64; in fp32 also head dim 256 (either dtype's forms are 64 and 128)
REFUSED = [(1024, 32), (320, 5), (384, 4)]
REFUSED_F32 = [(1024, 4), (320, 5), (384, 4)]


@pytest.mark.parametrize("C,heads,dtype", [
    *(pytest.param(C, h, torch.bfloat16, id=f"{C}-{h}") for C, h in REFUSED),
    *(pytest.param(C, h, torch.float32, id=f"{C}-{h}-fp32") for C, h in REFUSED_F32)])
def test_on_meets_the_fused_kernels_refusal(launches, C, heads, dtype):
    """"on" asks for the kernels whatever the width, in bf16 or in fp32 (each
    has a form in either): it raises, and is not turned into the plain
    chain."""
    with pytest.raises(ValueError, match="head dim 64|even head count"):
        _meta_block(C, heads, "frame", "on", dtype=dtype)()
    assert launches == []


def test_gates_take_any_cpu_width():
    """On the CPU the wrappers run their plain versions, so "auto" takes every
    width there, as before."""
    cfg = TB.BlockConfig(dim=384, num_heads=6, qk_norm=True)
    p = TB.init_block(torch.Generator().manual_seed(0), "cpu", cfg)
    x = torch.zeros((1, 4, 384), dtype=torch.bfloat16)
    rope = (torch.zeros((4, 64)), torch.zeros((4, 64)))
    assert TB._fused_qkv_applicable(p, cfg, x, rope)
    assert TB._fused_proj_applicable(p, cfg, x) and TB._fused_mlp_applicable(p, cfg, x)
    assert not TB._fused_mlp_applicable(p, cfg, x.float())
