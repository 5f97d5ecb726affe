"""Fused transformer-block kernels: LN+QKV(+qk-norm+RoPE), out-proj, MLP.

Port of ``self_supervise_sfm_tpu/ops/fused_qkv.py``. The five Pallas TPU
kernels, dtype-generic there, become hand-written CUDA kernels in two
bodies: in bf16, ``csrc/gemm_sm90.cu``, one persistent TMA + ``wgmma`` body
written for Hopper (the layer norm a pre-pass that writes the normalised
rows once; the out-projection reads the attention output's heads through a
3-D tensor map, with no merge copy); in fp32, ``csrc/gemm_f32.cu``, one
FFMA body on the CUDA cores (cp.async stages, 128 x 128 tiles; the same
pre-pass in fp32; the out-projection gathers its rows of o in place). Each
launch wrapper sits beside its plain PyTorch version:

- :func:`fused_ln_qkv_rope_fwd` replaces ``fused_qkv_kernel``: layer norm with
  fp32 statistics, ``@ W_qkv`` (C, 3 Hl d: every head, Hl = H, or under
  tensor parallelism one rank's head shard, its columns of q, of k and of v
  in ``[q_l | k_l | v_l]`` order) with fp32 accumulation rounded to x's dtype,
  the bias added in that dtype, per-head q/k layer norm over d, 2D RoPE in
  x's dtype, and q, k, v written as (B, H, N, d). Plain version
  :func:`fused_ln_qkv_rope_plain` (the JAX ``reference_qkv``).
- :func:`fused_ln_qkv_fwd` replaces ``fused_qkv_plain_kernel`` (no qk-norm, no
  RoPE: the ViT blocks). Plain version :func:`fused_ln_qkv_plain`.
- :func:`fused_proj_residual_fwd` replaces ``fused_proj_kernel``: head merge,
  ``@ W_proj`` + bias, layer-scale, residual. Plain version
  :func:`fused_proj_residual_plain`.
- :func:`fused_mlp_residual` replaces ``fused_mlp_kernel``'s two calls with
  :func:`fused_mlp_up` (LN2 + fc1 + exact GELU into a hidden written once)
  and :func:`fused_mlp_down` (fc2 + bias, layer-scale, residual), each with
  its own launch count. Plain versions :func:`fused_mlp_up_plain`,
  :func:`fused_mlp_down_plain`, :func:`fused_mlp_residual_plain`.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises. The activations and the weights
are of one dtype, which picks the body: bf16 (the ``*_sm90`` entries; the
weights cast once at load by ``cast_trunk_weights``; launches counted in
``.launches``) or fp32 (the ``*_f32`` entries; launches counted in
``.launches_f32``); a call that mixes them (fp32 x, bf16 weights) raises.
Norm, bias, layer-scale and RoPE parameters are fp32; head dim 64 or 128
in both bodies (at 128 LN+QKV(+RoPE) and the out-projection are the
``*_d128_sm90`` entries, launches counted in ``.launches_d128``, and the
``*_d128_f32`` ones, counted in ``.launches_d128_f32``), input widths that
are multiples of 64 and output widths that are multiples of 128 (both
bodies take the same widths), contiguous and 16-byte aligned. A launch
wrapper is forward only: under grad mode an input that requires grad raises, on every
device. The bf16 kernels are bound by the bf16 tensor-core rate at the main
path's sizes, the fp32 ones by the fp32 rate (see the source notes in the
``.cu`` files).

The four differentiable entries, :func:`fused_ln_qkv_rope`,
:func:`fused_ln_qkv`, :func:`fused_proj_residual` and
:func:`fused_mlp_residual`, are ``torch.autograd.Function``s, the JAX
package's ``custom_vjp``s: the forward is the launch wrappers, the backward
recomputes the plain chain and differentiates it (``_bwd``, ``_plain_bwd``,
``_proj_bwd``, ``_mlp_bwd``), its products in the input dtype as the JAX
reference chain's.

The plain versions repeat the kernels' arithmetic: every matrix product
multiplies the rounded operands in fp32 and rounds the sum once, as the
kernels' fp32 accumulators do.
"""

from __future__ import annotations

import torch

from .. import _kernels
from .flash_attention import _body, _count

# the head dims the kernels with one take (LN+QKV(+RoPE), the
# out-projection), the same in the Hopper body (bf16) and the FFMA body (fp32)
HEAD_DIMS = (64, 128)


# -- shared arithmetic of the plain versions ----------------------------------


def _ln_rows(x32, scale, bias, eps: float):
    """Row-wise layer norm in fp32, centred variance."""
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _linear(h, w, b, native: bool = False):
    """``h @ w`` with fp32 accumulation rounded to h's dtype, bias added in
    h's dtype. ``native`` multiplies in h's dtype (cuBLAS accumulates a bf16
    product in fp32 and rounds once, in another summation order): the
    backwards take it, so their products, like JAX's bf16 dots, run on the
    tensor cores."""
    dt = h.dtype
    if native:
        y = torch.matmul(h, w.to(dt))
    else:
        y = torch.matmul(h.float(), w.to(dt).float()).to(dt)
    return y + b.to(dt)


def _split_heads(t, num_heads: int):
    B, N, C = t.shape
    return t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _rope_rows(t, cos, sin):
    """2D RoPE in t's dtype; rot = (-t2, t1, -t4, t3) over quarters of d."""
    c, s = cos.to(t.dtype), sin.to(t.dtype)
    t1, t2, t3, t4 = t.chunk(4, dim=-1)
    rot = torch.cat([-t2, t1, -t4, t3], dim=-1)
    return t * c + rot * s


# -- checks of the CUDA wrappers ----------------------------------------------


def _check(name: str, dev, dtype, **tensors) -> None:
    """Raise on what the kernels do not take. A value is a tensor, or
    (tensor, shape) where the shape is fixed by the other arguments."""
    for key, t in tensors.items():
        t, shape = t if isinstance(t, tuple) else (t, None)
        if t.device != dev:
            raise ValueError(f"{name}: {key} lies on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(
                f"{name}: the kernel takes {dtype} for {key}, got {t.dtype} "
                "(weights in the activations' dtype: a bf16 trunk's are cast once at "
                "load by cast_trunk_weights)")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name}: forward only, {key} requires grad")


def _kernel_dtype(name: str, x) -> torch.dtype:
    """x's dtype, which picks the body (``_body``: bf16 the Hopper body's
    ``*_sm90`` entries, fp32 the FFMA body's ``*_f32`` ones) and which the
    weights must share (``_check``); any other raises."""
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"{name}: the kernels take bfloat16 or float32 activations, got {x.dtype}")
    return x.dtype


def _check_widths(name: str, *, head_dim=None, **widths: int) -> None:
    """A head dim the kernels take (``HEAD_DIMS``, in either body), and
    widths that are multiples of 64."""
    if head_dim is not None and head_dim not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head dim "
                         f"{' or '.join(map(str, HEAD_DIMS))}, got {head_dim}")
    for key, n in widths.items():
        if n % 64:
            raise ValueError(f"{name}: {key} = {n} is not a multiple of 64")


def _check_tile_widths(name: str, K: int, nout: int) -> None:
    """Both GEMM bodies read K in slices of 64 (the Hopper body's; the FFMA
    body's are 16, and its pre-pass's steps 4) and write tiles of 128
    columns. The layer-norm pre-passes take any K that is a multiple of 8
    (bf16) or 4 (fp32)."""
    if K % 64 or nout % 128:
        raise ValueError(f"{name}: the input width {K} must be a multiple of 64 and the "
                         f"output width {nout} a multiple of 128")


def _qkv_widths(name: str, x, w, num_heads: int) -> int:
    """The checks of LN+QKV(+RoPE)'s widths: x (B, N, C) and w (C, 3 Hl d)
    for the Hl = ``num_heads`` heads the call computes (all C / d, or a
    rank's head shard); d = 64 (Hl even) or 128 (any Hl), in either dtype; C
    a multiple of 64. Returns d."""
    C, nout = x.shape[2], w.shape[-1]
    if w.dim() != 2 or w.shape[0] != C or nout % (3 * num_heads):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"{num_heads} heads")
    d = nout // (3 * num_heads)
    _check_widths(name, head_dim=d, C=C)
    if d == 64 and num_heads % 2:
        raise ValueError(f"{name}: {num_heads} heads: a 128-column tile holds two heads "
                         "of one of q, k and v, so the kernel takes an even head count")
    _check_tile_widths(name, C, nout)
    return d


def qkv_kernel_takes(C: int, num_local_heads: int, head_dim: int = 64) -> bool:
    """Widths that the bf16 LN+QKV(+RoPE) take: an input width C a multiple
    of 64 (the GEMM's K slices) and Hl > 0 heads computed, at head dim 64
    with Hl even (a 128-column tile of the (C, 3 Hl 64) weight holds two
    heads of one of q, k and v) or at head dim 128 (a tile is one head). Hl
    is all C / d heads, or one rank's head shard under tensor parallelism,
    whose C stays the whole width. The checks of :func:`_qkv_widths`, as a
    predicate for the "auto" gates of ``layers/block.py``, which take the
    fused blocks for a bf16 trunk only (the fp32 body, whose head dims are
    the same, is reached under "on" alone)."""
    return (head_dim in HEAD_DIMS and C % 64 == 0 and num_local_heads > 0
            and (head_dim == 128 or num_local_heads % 2 == 0))


def proj_kernel_takes(C: int, num_heads: int) -> bool:
    """Widths that the bf16 out-projection takes: head dim 64 or 128, C a
    multiple of 128 (K and the output both C)."""
    return (C % num_heads == 0 and C // num_heads in HEAD_DIMS
            and C % 128 == 0)


def mlp_kernel_takes(C: int, hidden: int) -> bool:
    """Widths that MLP-up (K = C, output the hidden width) and MLP-down (K
    the hidden width, output C) both take: C and the hidden width multiples
    of 128 (no head condition)."""
    return C % 128 == 0 and hidden % 128 == 0


def _check_no_grad(name: str, *ts) -> None:
    """A launch wrapper's outputs have no ``grad_fn``: refuse to cut the
    autograd graph (the differentiable entries call it with grad mode off)."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: forward only; call the differentiable entry instead")


def _ln_scratch(x: torch.Tensor) -> torch.Tensor:
    """(B N, C) scratch in x's dtype for the layer-normed rows that a
    layer-normed kernel's pre-pass writes and its product reads."""
    return torch.empty((x.shape[0] * x.shape[1], x.shape[2]), dtype=x.dtype,
                       device=x.device)


# -- LN + QKV + qk-norm + RoPE ------------------------------------------------


def fused_ln_qkv_rope_plain(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias,
                            kn_scale, kn_bias, cos, sin, num_heads: int,
                            eps: float = 1e-5, native: bool = False):
    """The unfused chain. x: (B, N, C); cos/sin: (N, d) -> q, k, v (B, H, N, d)."""
    dt = x.dtype
    h = _ln_rows(x.float(), ln_scale, ln_bias, eps).to(dt)
    q, k, v = (_split_heads(t, num_heads)
               for t in _linear(h, w, b, native).chunk(3, dim=-1))
    q = _ln_rows(q.float(), qn_scale, qn_bias, eps).to(dt)
    k = _ln_rows(k.float(), kn_scale, kn_bias, eps).to(dt)
    return _rope_rows(q, cos, sin), _rope_rows(k, cos, sin), v


def fused_ln_qkv_rope_fwd(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias, kn_scale,
                          kn_bias, cos, sin, num_heads: int, eps: float = 1e-5):
    """(q, k, v) in (B, H, N, d) layout from the residual stream x (B, N, C)."""
    _check_no_grad("fused_ln_qkv_rope_fwd", x, ln_scale, ln_bias, w, b, qn_scale,
                   qn_bias, kn_scale, kn_bias, cos, sin)
    if x.device.type == "cpu":
        return fused_ln_qkv_rope_plain(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias,
                                       kn_scale, kn_bias, cos, sin, num_heads, eps)
    name = "fused_ln_qkv_rope"
    B, N, C = x.shape
    d = _qkv_widths(name, x, w, num_heads)
    _check(name, x.device, _kernel_dtype(name, x), x=x, w=w)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b=(b, (w.shape[1],)), qn_scale=(qn_scale, (d,)), qn_bias=(qn_bias, (d,)),
               kn_scale=(kn_scale, (d,)), kn_bias=(kn_bias, (d,)),
               cos=(cos, (N, d)), sin=(sin, (N, d)))
    q, k, v = (torch.empty((B, num_heads, N, d), dtype=x.dtype, device=x.device)
               for _ in range(3))
    if B and N:
        _kernels.launch(
            f"sfm_ln_qkv_rope_{_body(x.dtype, d)}", x.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(), qn_scale.data_ptr(),
            qn_bias.data_ptr(), kn_scale.data_ptr(), kn_bias.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ln_scratch(x).data_ptr(), B, N, C, num_heads, eps,
            _kernels.stream_ptr(x),
        )
        _count(fused_ln_qkv_rope_fwd, x.dtype, d)
    return q, k, v


fused_ln_qkv_rope_fwd.launches = 0
fused_ln_qkv_rope_fwd.launches_f32 = 0
fused_ln_qkv_rope_fwd.launches_d128 = 0
fused_ln_qkv_rope_fwd.launches_d128_f32 = 0


# -- LN + QKV, no qk-norm / RoPE (the ViT blocks) -----------------------------


def fused_ln_qkv_plain(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float = 1e-5,
                       native: bool = False):
    h = _ln_rows(x.float(), ln_scale, ln_bias, eps).to(x.dtype)
    q, k, v = (_split_heads(t, num_heads)
               for t in _linear(h, w, b, native).chunk(3, dim=-1))
    return q, k, v


def fused_ln_qkv_fwd(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float = 1e-5):
    """(q, k, v) in (B, H, N, d) layout, no qk-norm and no RoPE."""
    _check_no_grad("fused_ln_qkv_fwd", x, ln_scale, ln_bias, w, b)
    if x.device.type == "cpu":
        return fused_ln_qkv_plain(x, ln_scale, ln_bias, w, b, num_heads, eps)
    name = "fused_ln_qkv"
    B, N, C = x.shape
    d = _qkv_widths(name, x, w, num_heads)
    _check(name, x.device, _kernel_dtype(name, x), x=x, w=w)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b=(b, (w.shape[1],)))
    q, k, v = (torch.empty((B, num_heads, N, d), dtype=x.dtype, device=x.device)
               for _ in range(3))
    if B and N:
        _kernels.launch(
            f"sfm_ln_qkv_{_body(x.dtype, d)}", x.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(),
            w.data_ptr(), b.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _ln_scratch(x).data_ptr(), B, N, C, num_heads, eps,
            _kernels.stream_ptr(x),
        )
        _count(fused_ln_qkv_fwd, x.dtype, d)
    return q, k, v


fused_ln_qkv_fwd.launches = 0
fused_ln_qkv_fwd.launches_f32 = 0
fused_ln_qkv_fwd.launches_d128 = 0
fused_ln_qkv_fwd.launches_d128_f32 = 0


# -- head merge + out-projection + layer-scale + residual ---------------------


def fused_proj_residual_plain(o, x_res, w, b, ls_gamma, native: bool = False):
    """o: (B, H, N, d) head outputs; x_res: (B, N, C) -> (B, N, C)."""
    B, nh, N, d = o.shape
    m = o.transpose(1, 2).reshape(B, N, nh * d)
    return x_res + _linear(m, w, b, native) * ls_gamma.to(x_res.dtype)


def fused_proj_residual_fwd(o, x_res, w, b, ls_gamma):
    """y = x_res + layer_scale(merge_heads(o) @ w + b)."""
    _check_no_grad("fused_proj_residual_fwd", o, x_res, w, b, ls_gamma)
    if x_res.device.type == "cpu":
        return fused_proj_residual_plain(o, x_res, w, b, ls_gamma)
    name = "fused_proj_residual"
    B, nh, N, d = o.shape
    C = nh * d
    _check_widths(name, head_dim=d, C=C)
    if C % 128:  # the output's tiles of 128 columns (no pre-pass: at d = 64 any even head count)
        raise ValueError(f"{name}: C = {C} must be a multiple of 128")
    if tuple(x_res.shape) != (B, N, C) or tuple(w.shape) != (C, C):
        raise ValueError(f"{name}: o {tuple(o.shape)}, x {tuple(x_res.shape)}, "
                         f"w {tuple(w.shape)}")
    _check(name, x_res.device, _kernel_dtype(name, x_res), x_res=x_res, o=o, w=w)
    _check(name, x_res.device, torch.float32, b=(b, (C,)), ls_gamma=(ls_gamma, (C,)))
    y = torch.empty_like(x_res)
    if B and N:
        _kernels.launch(
            f"sfm_proj_residual_{_body(x_res.dtype, d)}", o.data_ptr(), x_res.data_ptr(),
            w.data_ptr(), b.data_ptr(), ls_gamma.data_ptr(), y.data_ptr(), B, N, nh,
            _kernels.stream_ptr(x_res),
        )
        _count(fused_proj_residual_fwd, x_res.dtype, d)
    return y


fused_proj_residual_fwd.launches = 0
fused_proj_residual_fwd.launches_f32 = 0
fused_proj_residual_fwd.launches_d128 = 0
fused_proj_residual_fwd.launches_d128_f32 = 0


# -- MLP: [LN2 + fc1 + GELU] and [fc2 + layer-scale + residual] ---------------


def fused_mlp_up_plain(x, ln_scale, ln_bias, w1, b1, eps: float = 1e-5,
                       native: bool = False):
    """LN2 -> fc1 -> exact (erf) GELU in fp32 -> hidden (B, N, Ch) in x's dtype."""
    dt = x.dtype
    hn = _ln_rows(x.float(), ln_scale, ln_bias, eps).to(dt)
    h32 = _linear(hn, w1, b1, native).float()
    return (0.5 * h32 * (1.0 + torch.erf(h32 * 2.0**-0.5))).to(dt)


def fused_mlp_down_plain(h, x, w2, b2, ls_gamma, native: bool = False):
    """fc2 -> layer-scale -> residual."""
    return x + _linear(h, w2, b2, native) * ls_gamma.to(x.dtype)


def fused_mlp_residual_plain(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma,
                             eps: float = 1e-5, native: bool = False):
    """The unfused chain: LN2 -> mlp -> layer-scale -> residual."""
    h = fused_mlp_up_plain(x, ln_scale, ln_bias, w1, b1, eps, native)
    return fused_mlp_down_plain(h, x, w2, b2, ls_gamma, native)


def fused_mlp_up(x, ln_scale, ln_bias, w1, b1, eps: float = 1e-5):
    """h = gelu(fc1(LN(x))), x: (B, N, C) -> (B, N, Ch)."""
    _check_no_grad("fused_mlp_up", x, ln_scale, ln_bias, w1, b1)
    if x.device.type == "cpu":
        return fused_mlp_up_plain(x, ln_scale, ln_bias, w1, b1, eps)
    name = "fused_mlp_up"
    B, N, C = x.shape
    Ch = w1.shape[1]
    _check_tile_widths(name, C, Ch)
    if tuple(w1.shape) != (C, Ch):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    _check(name, x.device, _kernel_dtype(name, x), x=x, w1=w1)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b1=(b1, (Ch,)))
    h = torch.empty((B, N, Ch), dtype=x.dtype, device=x.device)
    if B and N:
        _kernels.launch(
            f"sfm_mlp_up_{_body(x.dtype)}", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), h.data_ptr(), _ln_scratch(x).data_ptr(), B * N, C,
            Ch, eps,
            _kernels.stream_ptr(x),
        )
        _count(fused_mlp_up, x.dtype)
    return h


fused_mlp_up.launches = 0
fused_mlp_up.launches_f32 = 0


def _ln_rows_into(hn, x, ln_scale, ln_bias, eps: float) -> None:
    """The layer-norm pre-pass of LN+QKV(+RoPE) and MLP-up alone: hn (M, C)
    <- LN(x), in x's dtype (bf16 or fp32: each body's pre-pass). Not a path
    of its own (the wrappers launch it and count pre-pass and product as one
    launch); ``chip_smoke.py`` checks and times it apart."""
    M, C = hn.shape
    entry = "sfm_ln_rows_bf16" if x.dtype == torch.bfloat16 else "sfm_ln_rows_f32"
    _kernels.launch(entry, x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
                    hn.data_ptr(), M, C, eps, _kernels.stream_ptr(x))


def gemm_probe(a, w):
    """The TMA GEMM body with no epilogue: a (M, K) bf16 @ w (K, N)
    bf16 -> (M, N) fp32 accumulators, a check of its operand layouts (w read
    MN-major through wgmma's transposed-B bit) on the card. K a multiple of
    64, N of 128."""
    out = torch.empty((a.shape[0], w.shape[1]), dtype=torch.float32, device=a.device)
    _check("gemm_probe", a.device, torch.bfloat16, a=a, w=(w, (a.shape[1], w.shape[1])))
    _kernels.launch("sfm_gemm_sm90_probe", a.data_ptr(), w.data_ptr(), out.data_ptr(),
                    a.shape[0], a.shape[1], w.shape[1], _kernels.stream_ptr(a))
    return out


def fused_mlp_down(h, x, w2, b2, ls_gamma):
    """y = x + layer_scale(fc2(h)), h: (B, N, Ch), x: (B, N, C)."""
    _check_no_grad("fused_mlp_down", h, x, w2, b2, ls_gamma)
    if x.device.type == "cpu":
        return fused_mlp_down_plain(h, x, w2, b2, ls_gamma)
    name = "fused_mlp_down"
    B, N, C = x.shape
    Ch = h.shape[-1]
    _check_tile_widths(name, Ch, C)
    if tuple(h.shape) != (B, N, Ch) or tuple(w2.shape) != (Ch, C):
        raise ValueError(f"{name}: h {tuple(h.shape)}, x {tuple(x.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    _check(name, x.device, _kernel_dtype(name, x), x=x, h=h, w2=w2)
    _check(name, x.device, torch.float32, b2=(b2, (C,)), ls_gamma=(ls_gamma, (C,)))
    y = torch.empty_like(x)
    if B and N:
        _kernels.launch(
            f"sfm_mlp_down_{_body(x.dtype)}", h.data_ptr(), x.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), ls_gamma.data_ptr(), y.data_ptr(), B * N, Ch, C,
            _kernels.stream_ptr(x),
        )
        _count(fused_mlp_down, x.dtype)
    return y


fused_mlp_down.launches = 0
fused_mlp_down.launches_f32 = 0


# -- the differentiable entries ------------------------------------------------


def _plain_vjp(ctx, plain, grads):
    """Backward of a fused Function: recompute the plain chain on the saved
    inputs and differentiate it (the JAX ``_bwd``s' ``jax.vjp`` of the
    reference chain)."""
    saved = ctx.saved_tensors
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(need)
               for t, need in zip(saved, ctx.needs_input_grad)]
        outs = plain(*ins, *ctx.static, native=True)
        outs = outs if isinstance(outs, tuple) else (outs,)
        want = [t for t in ins if t.requires_grad]
        got = iter(torch.autograd.grad(outs, want, grads, allow_unused=True))
    return tuple(next(got) if t.requires_grad else None for t in ins) + (
        None,) * len(ctx.static)


class _LnQkvRope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b, qn_scale, qn_bias, kn_scale, kn_bias,
                cos, sin, num_heads, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias, kn_scale,
                              kn_bias, cos, sin)
        ctx.static = (num_heads, eps)
        return fused_ln_qkv_rope_fwd(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias,
                                     kn_scale, kn_bias, cos, sin, num_heads, eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        return _plain_vjp(ctx, fused_ln_qkv_rope_plain, (gq, gk, gv))


class _LnQkv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w, b, num_heads, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w, b)
        ctx.static = (num_heads, eps)
        return fused_ln_qkv_fwd(x, ln_scale, ln_bias, w, b, num_heads, eps)

    @staticmethod
    def backward(ctx, gq, gk, gv):
        return _plain_vjp(ctx, fused_ln_qkv_plain, (gq, gk, gv))


class _ProjResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, o, x_res, w, b, ls_gamma):
        ctx.save_for_backward(o, x_res, w, b, ls_gamma)
        ctx.static = ()
        return fused_proj_residual_fwd(o, x_res, w, b, ls_gamma)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(ctx, fused_proj_residual_plain, (g,))


class _MlpResidual(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, eps):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma)
        ctx.static = (eps,)
        h = fused_mlp_up(x, ln_scale, ln_bias, w1, b1, eps)
        return fused_mlp_down(h, x, w2, b2, ls_gamma)

    @staticmethod
    def backward(ctx, g):
        return _plain_vjp(ctx, fused_mlp_residual_plain, (g,))


def fused_ln_qkv_rope(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias, kn_scale,
                      kn_bias, cos, sin, num_heads: int, eps: float = 1e-5):
    """(q, k, v) in (B, H, N, d) layout from the residual stream x (B, N, C).
    Differentiable in every tensor argument."""
    return _LnQkvRope.apply(x, ln_scale, ln_bias, w, b, qn_scale, qn_bias, kn_scale,
                            kn_bias, cos, sin, num_heads, eps)


def fused_ln_qkv(x, ln_scale, ln_bias, w, b, num_heads: int, eps: float = 1e-5):
    """(q, k, v) in (B, H, N, d) layout, no qk-norm and no RoPE. Differentiable."""
    return _LnQkv.apply(x, ln_scale, ln_bias, w, b, num_heads, eps)


def fused_proj_residual(o, x_res, w, b, ls_gamma):
    """y = x_res + layer_scale(merge_heads(o) @ w + b). Differentiable."""
    return _ProjResidual.apply(o, x_res, w, b, ls_gamma)


def fused_mlp_residual(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma,
                       eps: float = 1e-5):
    """y = x + layer_scale(fc2(gelu(fc1(LN(x))))) as two kernels; the
    (B, N, Ch) hidden crosses device memory once. Differentiable; the
    backward recomputes the hidden in the plain chain."""
    return _MlpResidual.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, ls_gamma, eps)
