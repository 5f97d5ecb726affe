"""PyTorch port: the fused LN+QKV(+qk-norm+RoPE), out-proj and MLP functions.

The same numpy inputs (made as ``tests/test_fused_qkv.py`` makes them) go
through (i) the Pallas kernel in interpret mode, (ii) the JAX ``reference_*``
chain and (iii) the port's plain version, which is what the port's wrappers
run on a CPU tensor. Tolerances are the JAX package's own
(``tests/test_fused_qkv.py``): fp32 atol 2e-5 (summation order), bf16 atol
0.05 (one rounding at |y| ~ 4). For the MLP the Pallas kernel evaluates erf
by a rational approximation (|err| < 1.5e-7) where the port and the JAX
reference use the exact erf; that difference is inside the fp32 tolerance.

Then the port's block with the fused route forced against the JAX block with
the same switches (which off the TPU runs the references), against its own
unfused chain, and the gates of ``layers/block.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self_supervise_sfm_tpu.layers import block as JB
from self_supervise_sfm_tpu.layers import rope as JR
from self_supervise_sfm_tpu.ops import fused_qkv as JFQ
from self_supervise_sfm_tpu_torch import convert
from self_supervise_sfm_tpu_torch.layers import block as TB
from self_supervise_sfm_tpu_torch.ops import fused_qkv as TFQ

torch.set_num_threads(1)

F32_ATOL = 2e-5
BF16_ATOL = 0.05
DTYPES = {"float32": (jnp.float32, torch.float32, F32_ATOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, BF16_ATOL)}


def _np(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=None):
    """A JAX array as a torch tensor of the same values (bf16 via fp32)."""
    t = torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))
    return t if dtype is None else t.to(dtype)


def _close(port, kernel, ref, atol, names="qkv"):
    for t, k, r, nm in zip(port, kernel, ref, names):
        np.testing.assert_allclose(_np(t), _np(r), atol=atol, err_msg=f"{nm}: port vs reference")
        np.testing.assert_allclose(_np(t), _np(k), atol=atol, err_msg=f"{nm}: port vs kernel")


def _qkv_inputs(rng, N, dtype, B=2, C=128, nh=4):
    d = C // nh
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    x = jnp.asarray(rng.normal(size=(B, N, C)), dtype)
    args = [
        f32(1 + 0.1 * rng.normal(size=(C,))), f32(0.1 * rng.normal(size=(C,))),
        f32(rng.normal(scale=C**-0.5, size=(C, 3 * C))), f32(0.1 * rng.normal(size=(3 * C,))),
        f32(1 + 0.1 * rng.normal(size=(d,))), f32(0.1 * rng.normal(size=(d,))),
        f32(1 + 0.1 * rng.normal(size=(d,))), f32(0.1 * rng.normal(size=(d,))),
    ]
    cos, sin = JR.rope_tables(f32(rng.uniform(0, 30, size=(N, 2))), d)
    return x, args, cos, sin, nh


CASES = [(256, "float32"), (300, "float32"), (458, "float32"), (300, "bfloat16")]


@pytest.mark.parametrize("N,dtype", CASES)
def test_ln_qkv_rope_plain_matches_pallas_and_reference(rng, N, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, args, cos, sin, nh = _qkv_inputs(rng, N, jdt)
    ref = JFQ.reference_qkv(x, *args, cos, sin, num_heads=nh)
    ker = JFQ.fused_qkv_kernel(x, *args, cos, sin, num_heads=nh, block_n=128,
                               interpret=True)
    port = TFQ.fused_ln_qkv_rope(_t(x, tdt), *map(_t, args), _t(cos), _t(sin), nh)
    assert all(t.dtype == tdt and t.shape == (2, nh, N, 128 // nh) for t in port)
    _close(port, ker, ref, atol)


@pytest.mark.parametrize("N,dtype", CASES)
def test_ln_qkv_plain_matches_pallas_and_reference(rng, N, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, args, _, _, nh = _qkv_inputs(rng, N, jdt)
    args = args[:4]
    ref = JFQ.reference_qkv_plain(x, *args, num_heads=nh, eps=1e-6)
    ker = JFQ.fused_qkv_plain_kernel(x, *args, num_heads=nh, eps=1e-6, block_n=128,
                                     interpret=True)
    port = TFQ.fused_ln_qkv(_t(x, tdt), *map(_t, args), nh, 1e-6)
    assert all(t.dtype == tdt for t in port)
    _close(port, ker, ref, atol)


@pytest.mark.parametrize("N,dtype", [(256, "float32"), (300, "float32"), (300, "bfloat16")])
def test_proj_residual_plain_matches_pallas_and_reference(rng, N, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    B, nh, d = 2, 4, 32
    C = nh * d
    o = jnp.asarray(rng.normal(size=(B, nh, N, d)), jdt)
    x = jnp.asarray(rng.normal(size=(B, N, C)), jdt)
    w = jnp.asarray(rng.normal(scale=C**-0.5, size=(C, C)), jnp.float32)
    b = jnp.asarray(0.1 * rng.normal(size=(C,)), jnp.float32)
    ls = jnp.asarray(0.01 * rng.normal(size=(C,)), jnp.float32)
    ref = JFQ.reference_proj(o, x, w, b, ls)
    ker = JFQ.fused_proj_kernel(o, x, w, b, ls, block_n=128, interpret=True)
    port = TFQ.fused_proj_residual(_t(o, tdt), _t(x, tdt), _t(w), _t(b), _t(ls))
    assert port.dtype == tdt
    _close([port], [ker], [ref], atol, names=["y"])


def _mlp_inputs(rng, jdt, B=2, N=300, C=64, Ch=256):
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    x = jnp.asarray(rng.normal(size=(B, N, C)), jdt)
    return x, [
        f32(1 + 0.1 * rng.normal(size=(C,))), f32(0.1 * rng.normal(size=(C,))),
        f32(rng.normal(scale=C**-0.5, size=(C, Ch))), f32(0.1 * rng.normal(size=(Ch,))),
        f32(rng.normal(scale=Ch**-0.5, size=(Ch, C))), f32(0.1 * rng.normal(size=(C,))),
        f32(0.01 * rng.normal(size=(C,))),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_residual_plain_matches_pallas_and_reference(rng, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    x, args = _mlp_inputs(rng, jdt)
    ref = JFQ.reference_mlp(x, *args)
    ker = JFQ.fused_mlp_kernel(x, *args, block_n=128, interpret=True)
    targs = list(map(_t, args))
    port = TFQ.fused_mlp_residual(_t(x, tdt), *targs)
    assert port.dtype == tdt
    _close([port], [ker], [ref], atol, names=["y"])
    # the two halves compose to the whole
    h = TFQ.fused_mlp_up(_t(x, tdt), *targs[:4])
    assert h.shape == (2, 300, 256) and h.dtype == tdt
    assert torch.equal(TFQ.fused_mlp_down(h, _t(x, tdt), *targs[4:]), port)


# -- the block seam -----------------------------------------------------------


def _rand_block(rng, jcfg):
    """numpy block params in the structure ``init_block`` builds, with
    non-trivial norms, biases and layer-scales."""
    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        a = rng.normal(size=s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * a
        if name == "w":
            return a / np.sqrt(s.shape[0])
        return 0.1 * a
    shapes = jax.eval_shape(lambda: JB.init_block(jax.random.PRNGKey(0), jcfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _tabs(rng, n, hd, batch=None):
    shape = (n, 2) if batch is None else (batch, n, 2)
    jt = JR.rope_tables(jnp.asarray(rng.uniform(0, 20, size=shape), jnp.float32), hd)
    return jt, tuple(_t(a) for a in jt)


def _block_pair(rng, kind, **switches):
    """JAX and port configs + params of a ViT-type block (no qk-norm, no
    rope, eps 1e-6) or an aggregator-type block (qk-norm, rope, eps 1e-5)."""
    kw = dict(dim=128, num_heads=4, attn_impl="dense", **switches)
    kw.update(dict(qk_norm=False, ln_eps=1e-6, init_values=1.0) if kind == "vit"
              else dict(qk_norm=True, ln_eps=1e-5))
    jcfg, tcfg = JB.BlockConfig(**kw), TB.BlockConfig(**kw)
    p = _rand_block(rng, jcfg)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p),
            convert.from_jax_params(jax.tree.map(np.asarray, p)))


def _run_pair(rng, kind, frames=None, **switches):
    jcfg, tcfg, jp, tp = _block_pair(rng, kind, **switches)
    B, N = 2, 200
    if kind == "context":
        nc = 37
        x = rng.normal(size=(B * frames, N, 128)).astype(np.float32)
        ctx = rng.normal(size=(B, nc, 128)).astype(np.float32)
        jq, tq = _tabs(rng, N, 32)
        jc, tc = _tabs(rng, nc, 32, batch=B)
        j = jax.jit(JB.block_with_context, static_argnums=3)(
            jp, jnp.asarray(x), jnp.asarray(ctx), jcfg, jq, jc)
        t = TB.block_with_context(tp, torch.from_numpy(x), torch.from_numpy(ctx), tcfg,
                                  tq, tc)
        return j, t
    x = rng.normal(size=(B, N, 128)).astype(np.float32)
    jt, tt = (None, None) if kind == "vit" else _tabs(rng, N, 32)
    j = jax.jit(JB.block, static_argnums=2)(jp, jnp.asarray(x), jcfg, jt)
    return j, TB.block(tp, torch.from_numpy(x), tcfg, tt)


BLOCKS = [("vit", None), ("aggregator", None), ("context", 1), ("context", 3)]


@pytest.mark.parametrize("kind,frames", BLOCKS)
def test_block_fused_on_matches_jax_block_fused_on(rng, kind, frames):
    j, t = _run_pair(rng, kind, frames, fused_qkv="on", fused_mlp="on")
    np.testing.assert_allclose(_np(t), _np(j), atol=F32_ATOL)


@pytest.mark.parametrize("kind,frames", BLOCKS)
def test_block_fused_on_matches_own_unfused_chain_fp32(kind, frames):
    outs = [_run_pair(np.random.default_rng(0), kind, frames, fused_qkv=s, fused_mlp=s)[1]
            for s in ("on", "off")]
    np.testing.assert_allclose(_np(outs[0]), _np(outs[1]), atol=1e-5)


@pytest.fixture
def calls(monkeypatch):
    """Counts of the plain versions the wrappers reach on CPU tensors."""
    counts = {}
    for name in ("fused_ln_qkv_rope_plain", "fused_ln_qkv_plain",
                 "fused_proj_residual_plain", "fused_mlp_up_plain",
                 "fused_mlp_down_plain"):
        counts[name.replace("fused_", "").replace("_plain", "")] = 0

        def wrapped(*a, _orig=getattr(TFQ, name), _key=name, **k):
            counts[_key.replace("fused_", "").replace("_plain", "")] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(TFQ, name, wrapped)
    return counts


def _gate_run(rng, kind, dtype, rope="2d", **switches):
    _, tcfg, _, tp = _block_pair(rng, kind, **switches)
    x = torch.from_numpy(rng.normal(size=(2, 24, 128)).astype(np.float32)).to(dtype)
    tabs = None
    if rope == "2d":
        tabs = _tabs(rng, 24, 32)[1]
    elif rope == "3d":
        tabs = _tabs(rng, 24, 32, batch=2)[1]
    return TB.block(tp, x, tcfg, tabs)


ALL_FUSED = {"ln_qkv_rope": 1, "ln_qkv": 0, "proj_residual": 1, "mlp_up": 1, "mlp_down": 1}
NONE_FUSED = dict.fromkeys(ALL_FUSED, 0)


@pytest.mark.parametrize("mode,dtype,expected", [
    ("auto", torch.bfloat16, ALL_FUSED),
    ("auto", torch.float32, NONE_FUSED),
    ("on", torch.float32, ALL_FUSED),
    ("off", torch.bfloat16, NONE_FUSED),
])
def test_gates_follow_the_tri_state(rng, calls, mode, dtype, expected):
    out = _gate_run(rng, "aggregator", dtype, fused_qkv=mode, fused_mlp=mode)
    assert out.dtype == dtype and calls == expected


def test_gate_vit_block_takes_the_plain_qkv_kernel(rng, calls):
    _gate_run(rng, "vit", torch.bfloat16, rope=None)
    assert calls == {**ALL_FUSED, "ln_qkv_rope": 0, "ln_qkv": 1}


def test_gate_3d_rope_tables_fall_to_the_unfused_qkv(rng, calls):
    _gate_run(rng, "aggregator", torch.bfloat16, rope="3d")
    assert calls == {**ALL_FUSED, "ln_qkv_rope": 0}


def test_gate_qk_norm_without_rope_falls_to_the_unfused_qkv(rng, calls):
    _gate_run(rng, "aggregator", torch.bfloat16, rope=None)
    assert calls == {**ALL_FUSED, "ln_qkv_rope": 0}


def test_gate_switches_are_independent(rng, calls):
    _gate_run(rng, "aggregator", torch.bfloat16, fused_qkv="off", fused_mlp="auto")
    assert calls == {**NONE_FUSED, "mlp_up": 1, "mlp_down": 1}
    # the counts go on: the second run adds the qkv and proj calls alone
    _gate_run(rng, "aggregator", torch.bfloat16, fused_qkv="auto", fused_mlp="off")
    assert calls == ALL_FUSED


def test_context_block_fuses_only_the_query_half(rng, calls):
    """``block_with_context``: the context K/V (3-D rope tables) stay on the
    unfused chain; the query rows go through the fused kernels once."""
    _, tcfg, _, tp = _block_pair(rng, "aggregator")
    x = torch.from_numpy(rng.normal(size=(6, 24, 128)).astype(np.float32)).bfloat16()
    ctx = torch.from_numpy(rng.normal(size=(2, 9, 128)).astype(np.float32)).bfloat16()
    out = TB.block_with_context(tp, x, ctx, tcfg, _tabs(rng, 24, 32)[1],
                                _tabs(rng, 9, 32, batch=2)[1])
    assert out.shape == x.shape and calls == ALL_FUSED


def test_cuda_wrappers_raise_instead_of_falling_back():
    """On a CUDA tensor a wrapper launches or raises; what it refuses is
    checked before anything is built, so the checks run without a card."""
    bf = torch.zeros((2, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        TFQ._check("k", bf.device, torch.bfloat16, x=bf.float())
    with pytest.raises(ValueError, match="contiguous"):
        TFQ._check("k", bf.device, torch.bfloat16, x=bf.t())
    with pytest.raises(NotImplementedError, match="forward only"):
        TFQ._check("k", bf.device, torch.bfloat16, x=bf.clone().requires_grad_())
    with torch.no_grad():
        TFQ._check("k", bf.device, torch.bfloat16, x=bf.clone().requires_grad_())
    with pytest.raises(TypeError, match="float32"):
        TFQ._check("k", bf.device, torch.float32, b=(bf, (2, 8)))
    with pytest.raises(ValueError, match="shape"):
        TFQ._check("k", bf.device, torch.float32, b=(bf.float(), (8,)))
    with pytest.raises(ValueError, match="head dim 64"):
        TFQ._check_widths("k", head_dim=32, C=128)
    with pytest.raises(ValueError, match="multiple of 64"):
        TFQ._check_widths("k", head_dim=64, C=96)
    TFQ._check_widths("k", head_dim=64, C=1024, hidden=4096)
