"""PyTorch port at head dim 128 against the JAX package.

A model whose heads are 128 wide (``make_config(embed_dim=256,
num_heads=2)``: the ViT follows the aggregator's head count) runs, on the
card, the head dim 128 forms of K1, K1m, K2, K2p, LN+QKV+RoPE, LN+QKV and
the out-projection. On the CPU each of their wrappers runs its plain
version, so these tests hold:

- the whole model at a small size: the joint forward, ``build_scene_cache``,
  ``reloc`` and ``fast_reloc`` with every kernel gate forced to its wrapper
  (``attn_impl="flash"``, ``fused_qkv="on"``, ...) in fp32 against JAX's
  fp32 programs at ``tests/test_torch_model.py``'s and
  ``tests/test_torch_serving.py``'s tolerance, the wrappers' head dim
  counted; the bf16 trunk's "auto" gates take the fused blocks at head
  dim 128; weights in JAX's ``init_sailrecon`` tree (traced abstractly and
  filled by numpy, as ``tests/test_torch_converter.py`` fills them: no JAX
  init compiles) through ``convert.from_jax_params`` (the qk-norm scales
  (128,), the RoPE tables (N, 128)), explicit subsample indices;
- the plain versions of the seven kernels at d = 128 against the Pallas
  kernels in interpret mode (``_flash_fwd``, ``frame_ctx_kernel``,
  ``frame_ctx_packed_kernel``, ``fused_qkv_kernel``,
  ``fused_qkv_plain_kernel``, ``fused_proj_kernel``), in fp32 and bf16, at
  the tolerances the head dim 64 tests of the same modules use
  (``tests/test_torch_attention.py``, ``tests/test_torch_packed_attention.py``,
  ``tests/test_torch_fused_qkv.py``).

JAX compiles each model program once for the module, on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import rope as JR
from self_supervise_sfm_tpu.models import sailrecon as JM
from self_supervise_sfm_tpu.ops import flash_attention as JFA
from self_supervise_sfm_tpu.ops import fused_qkv as JFQ
from self_supervise_sfm_tpu.ops.mask_spec import RelocMask as JRelocMask
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.models import sailrecon as TM
from self_supervise_sfm_tpu_torch.ops import flash_attention as TFA
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ
from self_supervise_sfm_tpu_torch.ops.mask_spec import RelocMask

torch.set_num_threads(1)

D = 128
MODEL = dict(img_size=28, embed_dim=256, depth=4, num_heads=2, vit_depth=2,
             intermediate_layer_idx=(0, 1, 2, 3))
A = Q = 3
RANK = 2
P0 = (28 // 14) ** 2
KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf", "depth_map", "dpt_cnf",
        "point_map_by_unprojection", "cam_tokens")
# the model tests' fp32 tolerances (summation order, amplified by the
# random-init heads' exp / inverse-log activations)
FP32_TOL = dict(rtol=2e-4, atol=1e-4)
UNPROJECTION_TOL = dict(rtol=5e-4, atol=1e-4)
# every kernel site forced to its wrapper
KERNEL_ROUTE = dict(attn_impl="flash", global_attn_impl="flash", resize_impl="kernel",
                    fused_qkv="on", fused_mlp="on")
# the kernel tests' tolerances: attention (K1, K1m, K2), the packed cache
# (K2p), the fused blocks
ATTN_TOL = {"float32": 2e-5, "bfloat16": 1.6e-2}
PACKED_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FUSED_TOL = {"float32": 2e-5, "bfloat16": 0.05}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _run(fn, *args):
    """``jax.jit(fn)(*args)`` with LLVM's cheaper code generation (the same
    program in less compile time)."""
    return jax.jit(fn).lower(*args).compile(
        {"xla_backend_optimization_level": 0,
         "xla_llvm_disable_expensive_passes": True})(*args)


def _random_params(init_fn, seed=0):
    """numpy leaves in the structure ``init_fn`` builds, with non-trivial
    norms and biases and weights scaled by their fan-in."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        x = rng.normal(size=s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * x
        if name == "w" and len(s.shape) >= 2:
            return (x / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return 0.1 * x

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32)), x)


# -- the model --------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    jcfg = JM.make_config(**MODEL)
    assert jcfg.aggregator.head_dim == D and jcfg.aggregator.vit.embed_dim // (
        jcfg.aggregator.vit.num_heads) == D
    npp = _random_params(lambda: JM.init_sailrecon(jax.random.PRNGKey(0), jcfg))
    jp = jax.tree.map(jnp.asarray, npp)
    uniq = rng.uniform(size=(1, A, 28, 28, 3)).astype(np.float32)
    queries = rng.uniform(size=(1, Q, 28, 28, 3)).astype(np.float32)
    idx = np.stack([rng.permutation(P0)[:RANK] for _ in range(4 * A)])
    idx = idx.reshape(4, 1, A, RANK).astype(np.int32)
    tp = convert.from_jax_params(npp)
    qn = tp["aggregator"]["frame_blocks"][0]["attn"]["q_norm"]["scale"]
    assert tuple(qn.shape) == (D,)
    return dict(jcfg=jcfg, jp=jp, tp=tp, uniq=uniq, queries=queries, idx=idx,
                images=np.concatenate([uniq, uniq], axis=1))


@pytest.fixture(scope="module")
def jax_out(model):
    """JAX's fp32 forward, build and reloc."""
    m = model
    out = {"forward": _np(_run(lambda p, x, i: JM.forward(
        p, m["jcfg"], x, A, Q, rank=RANK, subsample_indices=i, images_duplicated=True),
        m["jp"], jnp.asarray(m["images"]), jnp.asarray(m["idx"])))}
    jcache, jcam = _run(lambda p, x, i: JM.build_scene_cache(
        p, m["jcfg"], x, rank=RANK, subsample_indices=i),
        m["jp"], jnp.asarray(m["uniq"]), jnp.asarray(m["idx"]))
    out["build"] = {"kv": _np(jcache["kv"]), "cam": _np(jcam)}
    out["reloc"] = _np(_run(lambda p, c, t, x: JM.reloc(p, m["jcfg"], c, t, x),
                            m["jp"], jcache, jcam, jnp.asarray(m["queries"])))
    return out


@pytest.fixture
def head_dims(monkeypatch):
    """The head dims the attention and fused-block wrappers saw, by wrapper."""
    seen = {}

    def spy(mod, name, dim):
        orig = getattr(mod, name)

        def wrapped(*a, **k):
            seen.setdefault(name, set()).add(dim(*a))
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("flash_fwd", "frame_ctx_fwd", "frame_ctx_packed_fwd"):
        spy(TFA, name, lambda q, *a: q.shape[-1])
    for name in ("fused_ln_qkv_rope_fwd", "fused_ln_qkv_fwd"):
        # (x, ln_scale, ln_bias, w, ..., num_heads, eps): w is (C, 3 H d)
        spy(TFQ, name, lambda x, ln_s, ln_b, w, *a: w.shape[-1] // (3 * a[-2]))
    spy(TFQ, "fused_proj_residual_fwd", lambda o, *a: o.shape[-1])
    return seen


def _compare(out, ref, keys=KEYS):
    for k in keys:
        a, b = out[k].float().numpy(), ref[k]
        assert a.shape == b.shape, k
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=k)
        tol = UNPROJECTION_TOL if k == "point_map_by_unprojection" else FP32_TOL
        np.testing.assert_allclose(a[fin], b[fin], err_msg=k, **tol)
    for a, b in zip(out["pose_enc_list"], ref["pose_enc_list"]):
        np.testing.assert_allclose(a.float().numpy(), b, **FP32_TOL)


def test_forward_d128_on_the_kernel_route_matches_jax(model, jax_out, head_dims):
    """fp32, every site on its kernel wrapper (the plain versions here): the
    attention wrappers and the three fused blocks with a head dim see 128
    wide heads only; the outputs at the fp32 tolerance of JAX's forward."""
    m = model
    cfg = TM.make_config(**MODEL, **KERNEL_ROUTE)
    out = TM.forward(m["tp"], cfg, m["images"], A, Q, rank=RANK,
                     subsample_indices=torch.from_numpy(m["idx"]), images_duplicated=True,
                     device="cpu")
    assert head_dims == {"flash_fwd": {D}, "frame_ctx_fwd": {D}, "fused_ln_qkv_rope_fwd": {D},
                         "fused_ln_qkv_fwd": {D}, "fused_proj_residual_fwd": {D}}
    _compare(out, jax_out["forward"])


def test_bf16_trunk_takes_the_fused_blocks_at_d128(model, head_dims):
    """The bf16 trunk on its "auto" route: every block on the fused wrappers
    (their plain versions on the CPU) at head dim 128, the attention sites
    dense at this size (under the gates' 1.5M-logit cut); finite poses."""
    m = model
    cfg = TM.make_config(compute_dtype="bfloat16", **MODEL)
    out = TM.forward(TM.cast_trunk_weights(m["tp"], cfg), cfg, m["images"], A, Q, rank=RANK,
                     subsample_indices=torch.from_numpy(m["idx"]), images_duplicated=True,
                     device="cpu")
    assert head_dims == {"fused_ln_qkv_rope_fwd": {D}, "fused_ln_qkv_fwd": {D},
                         "fused_proj_residual_fwd": {D}}
    assert all(bool(torch.isfinite(out[k]).all()) for k in ("extrinsic", "intrinsic"))


@pytest.mark.parametrize("part", ["build", "reloc"])
def test_serving_d128_on_the_kernel_route_matches_jax(model, jax_out, head_dims, part):
    """The scene-cache build (the cache (depth, 1, 2, A (rank + 5), 2 x 128))
    and reloc against it, fp32 on the kernel route (K2p's plain version reads
    the cache), against JAX's."""
    m = model
    cfg = TM.make_config(**MODEL, **KERNEL_ROUTE)
    cache, cam = TM.build_scene_cache(m["tp"], cfg, m["uniq"], rank=RANK,
                                      subsample_indices=torch.from_numpy(m["idx"]),
                                      device="cpu")
    assert tuple(cache["kv"].shape) == (MODEL["depth"], 1, 2, A * (RANK + 5), 2 * D)
    if part == "build":
        ref = jax_out["build"]
        np.testing.assert_allclose(cache["kv"].numpy(), ref["kv"], **FP32_TOL)
        np.testing.assert_allclose(cam.numpy(), ref["cam"], **FP32_TOL)
        return
    head_dims.clear()
    out = TM.reloc(m["tp"], cfg, cache, cam, m["queries"], device="cpu")
    assert head_dims["frame_ctx_packed_fwd"] == {D} and head_dims["flash_fwd"] == {D}
    ref = jax_out[part]
    keys = [k for k in KEYS + ("xyz_conf_fractions",) if k in ref]
    _compare(out, ref, keys)


# -- the plain versions against the Pallas kernels ----------------------------------


def _pair(rng, shape, dtype):
    jd, td = DTYPES[dtype]
    a = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jd)
    return a, torch.from_numpy(np.array(a.astype(jnp.float32))).to(td)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["K1", "K1m", "K2", "K2p"])
def test_attention_plain_d128_matches_pallas(dtype, kernel):
    """K1 (200 x 333 keys), K1m (RelocMask(77, 130, 2)), K2 (2 frames of 130
    rows, 77 context keys) and K2p (the same context as layer 1 of a 2-layer
    cache) at d = 128: the port's plain versions against the Pallas kernels
    in interpret mode."""
    rng = np.random.default_rng({"K1": 1, "K1m": 2, "K2": 3, "K2p": 4}[kernel])
    if kernel in ("K1", "K1m"):
        mask = RelocMask(77, 130, 2) if kernel == "K1m" else None
        nq, nk = (mask.nq, mask.nk) if mask else (200, 333)
        (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, n, D), dtype) for n in (nq, nk, nk))
        out, lse = TFA.flash_fwd_plain(tq, tk, tv, mask)
        j_out, j_lse = JFA._flash_fwd(jq, jk, jv, JRelocMask(77, 130, 2) if mask else None,
                                      128, 128, True)
        np.testing.assert_allclose(_np(out), _np(j_out), atol=ATTN_TOL[dtype])
        np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), atol=1e-4, rtol=1e-5)
        return
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 2, 130, D), dtype) for _ in range(3))
    if kernel == "K2":
        (jck, tck), (jcv, tcv) = (_pair(rng, (1, 2, 77, D), dtype) for _ in range(2))
        out = TFA._frame_ctx_dense(tq, tk, tv, tck, tcv)
        ref = JFA.frame_ctx_kernel(jq, jk, jv, jck, jcv, bq=128, bk=128, interpret=True)
        np.testing.assert_allclose(_np(out), _np(ref), atol=ATTN_TOL[dtype])
        return
    jc, tc = _pair(rng, (2, 1, 2, 77, 2 * D), dtype)
    out = TFA.frame_ctx_packed_plain(tq, tk, tv, tc, 1)
    ref = JFA.frame_ctx_packed_kernel(jq, jk, jv, jc, 1, bq=128, bk=128, interpret=True)
    np.testing.assert_allclose(_np(out), _np(ref), atol=PACKED_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["ln_qkv_rope", "ln_qkv", "proj"])
def test_fused_plain_d128_matches_pallas(dtype, kernel):
    """LN+QKV+RoPE, LN+QKV and the out-projection at 2 heads of 128 (C 256,
    300 rows a frame, 2 frames): the port's plain versions against the
    Pallas kernels in interpret mode."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng({"ln_qkv_rope": 5, "ln_qkv": 6, "proj": 7}[kernel])
    B, N, nh = 2, 300, 2
    C = nh * D
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    t = lambda a, dt=None: (torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))  # noqa: E731
                            .to(dt or torch.float32))
    if kernel == "proj":
        o = jnp.asarray(rng.normal(size=(B, nh, N, D)), jd)
        x = jnp.asarray(rng.normal(size=(B, N, C)), jd)
        w, b = f32(rng.normal(scale=C**-0.5, size=(C, C))), f32(0.1 * rng.normal(size=(C,)))
        ls = f32(0.01 * rng.normal(size=(C,)))
        ref = [JFQ.fused_proj_kernel(o, x, w, b, ls, block_n=128, interpret=True)]
        port = [TFQ.fused_proj_residual_plain(t(o, td), t(x, td), t(w), t(b), t(ls))]
    else:
        x = jnp.asarray(rng.normal(size=(B, N, C)), jd)
        args = [f32(1 + 0.1 * rng.normal(size=(C,))), f32(0.1 * rng.normal(size=(C,))),
                f32(rng.normal(scale=C**-0.5, size=(C, 3 * C))),
                f32(0.1 * rng.normal(size=(3 * C,)))]
        if kernel == "ln_qkv":
            ref = JFQ.fused_qkv_plain_kernel(x, *args, num_heads=nh, eps=1e-6, block_n=128,
                                             interpret=True)
            port = TFQ.fused_ln_qkv_plain(t(x, td), *map(t, args), nh, 1e-6)
        else:
            norms = [f32(1 + 0.1 * rng.normal(size=(D,))), f32(0.1 * rng.normal(size=(D,))),
                     f32(1 + 0.1 * rng.normal(size=(D,))), f32(0.1 * rng.normal(size=(D,)))]
            cos, sin = JR.rope_tables(f32(rng.uniform(0, 30, size=(N, 2))), D)
            ref = JFQ.fused_qkv_kernel(x, *args, *norms, cos, sin, num_heads=nh, block_n=128,
                                       interpret=True)
            port = TFQ.fused_ln_qkv_rope_plain(t(x, td), *map(t, args), *map(t, norms), t(cos),
                                               t(sin), nh)
        assert all(tuple(p.shape) == (B, nh, N, D) and p.dtype == td for p in port)
    for p, r in zip(port, ref):
        np.testing.assert_allclose(_np(p), _np(r), atol=FUSED_TOL[dtype])
