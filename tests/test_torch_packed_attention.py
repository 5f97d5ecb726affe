"""PyTorch port: the in-place kv2 reloc attention (K2p) and the RelocMask
flash variant (K1m) vs the JAX package.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold those plain versions against the Pallas kernels in interpret mode and
the JAX dense references, on the same numpy inputs, and the port's
``RelocMask`` / ``reloc_split_attention`` against the JAX ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import attention as JAT
from self_supervise_sfm_tpu.ops import attention_core as JAC
from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu_torch.layers import attention as TAT
from self_supervise_sfm_tpu_torch.ops import attention_core as TAC
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# fp32: summation order only. bf16: the same bf16 inputs on both sides, bf16
# outputs, p rounded to bf16 before PV on both sides.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _pair(rng, shape, dtype):
    jd, td = DTYPES[dtype]
    a = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# -- K2p: frame-context attention against the kv2 cache --------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,F,P,nc,depth", [
    (1, 3, 96, 160, 3),   # ragged frame and context against the key tiles
    (2, 2, 70, 45, 2),    # two scenes, each with its own context
    (1, 2, 40, 0, 2),     # no context: plain per-frame attention
])
@pytest.mark.parametrize("last", [False, True], ids=["layer0", "layer_last"])
def test_packed_plain_matches_jax(rng, dtype, B, F, P, nc, depth, last):
    H, d = 2, 64
    layer = depth - 1 if last else 0
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (B * F, H, P, d), dtype) for _ in range(3))
    jc, tc = _pair(rng, (depth, B, H, nc, 2 * d), dtype)
    out = TFA.frame_ctx_packed_plain(tq, tk, tv, tc, layer)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    dense = JFA._frame_ctx_dense(jq, jk, jv, jc[layer, ..., :d], jc[layer, ..., d:])
    np.testing.assert_allclose(_f32(out), _f32(dense), atol=TOL[dtype])
    if nc:
        # the Pallas kernel in interpret mode (it takes no empty context)
        kern = JFA.frame_ctx_packed_kernel(jq, jk, jv, jc, layer, bq=128, bk=128,
                                           interpret=True)
        np.testing.assert_allclose(_f32(out), _f32(kern), atol=TOL[dtype])
    else:
        own = TFA.flash_fwd_plain(*(t.reshape(B * F * H, P, d) for t in (tq, tk, tv)))[0]
        np.testing.assert_allclose(_f32(out), _f32(own.reshape(out.shape)),
                                   atol=TOL[dtype])
    # the wrapper and the dispatch (a CPU tensor: the plain version)
    assert torch.equal(TFA.frame_ctx_packed_fwd(tq, tk, tv, tc, layer), out)
    for impl in ("flash", "auto", "dense"):
        got = TFA.packed_ctx_attention(tq, tk, tv, tc, layer, impl=impl)
        np.testing.assert_allclose(_f32(got), _f32(out), atol=1e-6)
    ref = JFA.packed_ctx_attention(jq, jk, jv, jc, layer)
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=TOL[dtype])


def test_packed_equals_k2_on_the_split_cache(rng):
    """K2p against the stacked cache == K2 against that layer's split halves."""
    B, F, P, nc, H, d, depth = 2, 2, 50, 33, 2, 64, 3
    tq, tk, tv = (_pair(rng, (B * F, H, P, d), "bfloat16")[1] for _ in range(3))
    tc = _pair(rng, (depth, B, H, nc, 2 * d), "bfloat16")[1]
    for layer in range(depth):
        a = TFA.frame_ctx_packed_fwd(tq, tk, tv, tc, layer)
        b = TFA.frame_ctx_fwd(tq, tk, tv, tc[layer, ..., :d].contiguous(),
                              tc[layer, ..., d:].contiguous())
        assert torch.equal(a, b)


def test_packed_wrapper_checks_and_leaves_the_cache_untouched(rng):
    B, F, P, nc, H, d, depth = 1, 2, 24, 17, 2, 64, 4
    tq, tk, tv = (_pair(rng, (B * F, H, P, d), "float32")[1] for _ in range(3))
    tc = _pair(rng, (depth, B, H, nc, 2 * d), "float32")[1]
    before = tc.clone()
    ptr = tc.data_ptr()
    TFA.frame_ctx_packed_fwd(tq, tk, tv, tc, 2)
    assert torch.equal(tc, before) and tc.data_ptr() == ptr
    for fn in (TFA.frame_ctx_packed_fwd, TFA.frame_ctx_packed_plain):
        for bad in (-1, depth, depth + 3):
            with pytest.raises(IndexError, match="layer"):
                fn(tq, tk, tv, tc, bad)
        # a segment of the cache has its own leading dim
        with pytest.raises(IndexError, match="layer"):
            fn(tq, tk, tv, tc[:2], 2)
        fn(tq, tk, tv, tc[2:], 1)
        with pytest.raises(ValueError, match="contiguous"):
            fn(tq, tk, tv, tc[:, :, :, ::2], 0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(tq, tk, tv, torch.cat([tc, tc], dim=3)[:, :, :, :nc], 0)  # a view
        with pytest.raises(ValueError, match="shapes"):
            fn(tq, tk, tv, tc[..., :d], 0)  # rows of k only
        with pytest.raises(ValueError, match="shapes"):
            fn(tq, tk[:, :, :5], tv, tc, 0)
        with pytest.raises(ValueError, match="depth, B, H, Nc, 2d"):
            fn(tq, tk, tv, tc[0], 0)


# -- RelocMask ------------------------------------------------------------------

MASKS = [(160, 96, 3), (256, 128, 4), (50, 30, 2), (25, 40, 3), (0, 7, 2), (5, 1, 4)]


@pytest.mark.parametrize("n_ctx,frame,frames", MASKS)
def test_reloc_mask_matches_jax(n_ctx, frame, frames):
    tm, jm = RelocMask(n_ctx, frame, frames), JRelocMask(n_ctx, frame, frames)
    assert (tm.nq, tm.nk) == (jm.nq, jm.nk)
    dense = np.asarray(jm.materialize())
    got = tm.materialize()
    assert got.dtype == torch.bool and tuple(got.shape) == dense.shape
    np.testing.assert_array_equal(got.numpy(), dense)
    qi = torch.arange(tm.nq)[:, None]
    ki = torch.arange(tm.nk)[None, :]
    np.testing.assert_array_equal(tm.allowed(qi, ki).numpy(), dense[0, 0])
    assert bool(tm.allowed(0, 0)) == bool(dense[0, 0, 0, 0])
    # block_visible on tiles of several sizes, against the JAX class and
    # against the materialised mask (it may only over-approximate)
    for bq, bk in ((16, 16), (64, 32), (128, 128)):
        for q0 in range(0, tm.nq, bq):
            for k0 in range(0, tm.nk, bk):
                q1, k1 = q0 + bq, k0 + bk
                vis = bool(tm.block_visible(q0, q1, k0, k1))
                assert vis == bool(jm.block_visible(q0, q1, k0, k1))
                if dense[0, 0, q0:q1, k0:k1].any():
                    assert vis


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_ctx,frame,frames", MASKS[:4] + [(0, 40, 2)])
def test_masked_flash_plain_matches_jax(rng, dtype, n_ctx, frame, frames):
    tm, jm = RelocMask(n_ctx, frame, frames), JRelocMask(n_ctx, frame, frames)
    B, H, d = 1, 2, 64
    jq, tq = _pair(rng, (B, H, tm.nq, d), dtype)
    (jk, tk), (jv, tv) = (_pair(rng, (B, H, tm.nk, d), dtype) for _ in range(2))
    out, lse = TFA.flash_attention_lse(tq, tk, tv, tm)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    j_out, j_lse = JFA.flash_attention_lse(jq, jk, jv, jm, bq=128, bk=128,
                                           interpret=True)
    np.testing.assert_allclose(_f32(out), _f32(j_out), atol=TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-4, rtol=1e-5)
    # the dense paths, on a spec and on its materialised form, both sides
    np.testing.assert_allclose(_f32(out), _f32(JAC.sdpa_dense(jq, jk, jv, jm)),
                               atol=TOL[dtype])
    dense = TAC.sdpa_dense(tq, tk, tv, tm)
    np.testing.assert_allclose(_f32(out), _f32(dense), atol=TOL[dtype])
    assert torch.equal(dense, TAC.sdpa_dense(tq, tk, tv, tm.materialize()))
    # the dispatch hands a RelocMask to the masked flash wrapper
    assert torch.equal(TAC.sdpa(tq, tk, tv, tm, impl="flash"), out)
    assert torch.equal(TAC.sdpa(tq, tk, tv, tm, impl="dense"), dense)
    assert TFA.supported(tq, tk, tv, tm) and TFA.supported(tq, tk, tv, None)
    assert not TFA.supported(tq, tk, tv, tm.materialize())


def test_masked_flash_checks_the_mask(rng):
    tq = _pair(rng, (2, 8, 64), "float32")[1]
    tk = _pair(rng, (2, 12, 64), "float32")[1]
    TFA.flash_fwd_reloc(tq, tk, tk, RelocMask(4, 4, 2))
    for bad in (RelocMask(4, 4, 3), RelocMask(5, 4, 2), RelocMask(4, 8, 1)):
        ok = bad.nq == 8 and bad.nk == 12
        if ok:
            TFA.flash_fwd_reloc(tq, tk, tk, bad)
            continue
        with pytest.raises(ValueError, match="does not describe"):
            TFA.flash_fwd_reloc(tq, tk, tk, bad)


def test_masked_attention_equals_the_frame_major_layout(rng):
    """Mask form == layout form: RelocMask attention over the
    [ctx ‖ all frames] axis is the per-frame [ctx ‖ own] attention."""
    B, F, P, nc, H, d = 1, 3, 96, 160, 2, 64
    tm = RelocMask(nc, P, F)
    tq = _pair(rng, (B, H, F * P, d), "float32")[1]
    tk, tv = (_pair(rng, (B, H, nc + F * P, d), "float32")[1] for _ in range(2))
    masked = TFA.flash_attention(tq, tk, tv, tm)

    def fold(x):
        return x.reshape(B, H, F, P, d).transpose(1, 2).reshape(B * F, H, P, d)

    ck, cv = tk[:, :, :nc].contiguous(), tv[:, :, :nc].contiguous()
    layout = TFA.frame_ctx_fwd(fold(tq), fold(tk[:, :, nc:]), fold(tv[:, :, nc:]), ck, cv)
    layout = layout.reshape(B, F, H, P, d).transpose(1, 2).reshape(B, H, F * P, d)
    np.testing.assert_allclose(masked.numpy(), layout.numpy(), atol=2e-5)
    packed = TFA.frame_ctx_packed_fwd(
        fold(tq), fold(tk[:, :, nc:]), fold(tv[:, :, nc:]),
        torch.cat([ck, cv], dim=-1)[None], 0)
    packed = packed.reshape(B, F, H, P, d).transpose(1, 2).reshape(B, H, F * P, d)
    assert torch.equal(packed, layout)


# -- reloc_split_attention ---------------------------------------------------------


def _split_inputs(rng, B, H, F, P, nctx, d, dtype="float32"):
    return [_pair(rng, (B, H, n, d), dtype)
            for n in (F * P, F * P, F * P, nctx, nctx)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reloc_split_matches_jax(rng, dtype):
    B, H, F, P, nctx, d = 1, 2, 3, 40, 25, 16
    pairs = _split_inputs(rng, B, H, F, P, nctx, d, dtype)
    j, t = [p[0] for p in pairs], [p[1] for p in pairs]
    out = TAC.reloc_split_attention(*t, RelocMask(nctx, P, F))
    ref = JAC.reloc_split_attention(*j, JRelocMask(nctx, P, F))
    tol = 3e-6 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(_f32(out), _f32(ref), atol=tol)
    tq, tks, tvs, tkc, tvc = t
    dense = TAC.sdpa_dense(tq, torch.cat([tkc, tks], 2), torch.cat([tvc, tvs], 2),
                           RelocMask(nctx, P, F))
    np.testing.assert_allclose(_f32(out), _f32(dense), atol=tol)


def test_reloc_split_shape_mismatch_returns_none(rng):
    t = [p[1] for p in _split_inputs(rng, 1, 2, 2, 24, 17, 8)]
    j = [p[0] for p in _split_inputs(rng, 1, 2, 2, 24, 17, 8)]
    for n_ctx, frame, frames in ((17, 24, 3), (16, 24, 2)):
        assert TAC.reloc_split_attention(*t, RelocMask(n_ctx, frame, frames)) is None
        assert JAC.reloc_split_attention(*j, JRelocMask(n_ctx, frame, frames)) is None


def test_merge_is_the_exact_softmax_over_the_union(rng):
    q = _pair(rng, (2, 9, 64), "float32")[1]
    k, v = (_pair(rng, (2, 30, 64), "float32")[1] for _ in range(2))
    o_a, l_a = TFA.flash_fwd_plain(q, k[:, :11], v[:, :11])
    o_b, l_b = TFA.flash_fwd_plain(q, k[:, 11:], v[:, 11:])
    out, lse = TAC._merge(o_a.float(), l_a, o_b.float(), l_b)
    ref, ref_lse = TFA.flash_fwd_plain(q, k, v)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-6)
    np.testing.assert_allclose(lse.numpy(), ref_lse.numpy(), atol=2e-6)


@pytest.mark.parametrize("impl", ["auto", "flash", "dense"])
@pytest.mark.parametrize("F,P,nctx,split", [(2, 24, 17, False), (2, 600, 660, True)],
                         ids=["small_concat", "large_split"])
def test_attention_layer_masked_branch_matches_jax(rng, impl, F, P, nctx, split,
                                                   monkeypatch):
    """``attention_heads_out`` with extra K/V and a RelocMask: at or above
    the size cut (F*P * (n_ctx + P) >= 1.5M) and off the dense path the split
    form runs, else the concatenation goes to the masked sdpa; both against
    the JAX layer's dense path."""
    B, H, d = 1, 1, 16
    pairs = _split_inputs(rng, B, H, F, P, nctx, d)
    (jq, tq), (jk, tk), (jv, tv), (jkc, tkc), (jvc, tvc) = pairs
    jcfg = JAT.AttentionConfig(dim=H * d, num_heads=H, impl="dense")
    ref = JAT.attention_heads_out({}, jq, jk, jv, jcfg, JRelocMask(nctx, P, F),
                                  extra_kv=(jkc, jvc))
    calls = []
    orig = TAC.reloc_split_attention
    monkeypatch.setattr(TAC, "reloc_split_attention",
                        lambda *a: calls.append(1) or orig(*a))
    tcfg = TAT.AttentionConfig(dim=H * d, num_heads=H, impl=impl)
    out = TAT.attention_heads_out({}, tq, tk, tv, tcfg, RelocMask(nctx, P, F),
                                  extra_kv=(tkc, tvc))
    assert len(calls) == int(split and impl != "dense")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
