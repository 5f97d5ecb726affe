"""Fused transformer-block kernels: LN+QKV(+qk-norm+RoPE), out-proj, MLP.

Port of ``self_supervise_sfm_tpu/ops/fused_qkv.py``. The five Pallas TPU
kernels become five hand-written CUDA kernels in ``csrc/fused_block.cu``
over one GEMM body (``csrc/gemm_core.cuh``); each launch wrapper sits beside
its plain PyTorch version:

- :func:`fused_ln_qkv_rope_fwd` replaces ``fused_qkv_kernel``: layer norm with
  fp32 statistics, ``@ W_qkv`` with fp32 accumulation rounded to x's dtype,
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
tensor it launches the kernel or raises: bf16 activations and weights (the
weights cast once at load by ``cast_trunk_weights``), fp32 norm, bias and
layer-scale parameters, head dim 64, widths that are multiples of 64,
contiguous and 16-byte aligned. A launch wrapper is forward only: under
grad mode an input that requires grad raises, on every device. All five
kernels are bound by the bf16 tensor-core rate at the main path's sizes
(see the source note in the ``.cu`` file).

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

KERNEL_HEAD_DIM = 64


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
                "(the trunk's weights are cast once at load by cast_trunk_weights)")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be contiguous and 16-byte aligned")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(f"{name}: forward only, {key} requires grad")


def _check_widths(name: str, *, head_dim=None, **widths: int) -> None:
    if head_dim is not None and head_dim != KERNEL_HEAD_DIM:
        raise ValueError(
            f"{name}: the kernel takes head dim {KERNEL_HEAD_DIM}, got {head_dim}")
    for key, n in widths.items():
        if n % 64:
            raise ValueError(f"{name}: {key} = {n} is not a multiple of 64")


def _check_no_grad(name: str, *ts) -> None:
    """A launch wrapper's outputs have no ``grad_fn``: refuse to cut the
    autograd graph (the differentiable entries call it with grad mode off)."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: forward only; call the differentiable entry instead")


def _row_stats_scratch(x: torch.Tensor) -> torch.Tensor:
    """(rows, 2) fp32 scratch for the layer-norm statistics (mean, rstd) that
    a layer-normed kernel's pre-pass writes and its product reads."""
    return torch.empty((x.shape[0] * x.shape[1], 2), dtype=torch.float32,
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
    d = C // num_heads
    _check_widths(name, head_dim=d, C=C)
    if C != num_heads * d or tuple(w.shape) != (C, 3 * C):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"{num_heads} heads")
    _check(name, x.device, torch.bfloat16, x=x, w=w)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b=(b, (3 * C,)), qn_scale=(qn_scale, (d,)), qn_bias=(qn_bias, (d,)),
               kn_scale=(kn_scale, (d,)), kn_bias=(kn_bias, (d,)),
               cos=(cos, (N, d)), sin=(sin, (N, d)))
    q, k, v = (torch.empty((B, num_heads, N, d), dtype=x.dtype, device=x.device)
               for _ in range(3))
    if B and N:
        _kernels.launch(
            "sfm_fused_ln_qkv_rope", x.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w.data_ptr(), b.data_ptr(), qn_scale.data_ptr(),
            qn_bias.data_ptr(), kn_scale.data_ptr(), kn_bias.data_ptr(),
            cos.data_ptr(), sin.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _row_stats_scratch(x).data_ptr(), B, N, num_heads, eps,
            _kernels.stream_ptr(x),
        )
        fused_ln_qkv_rope_fwd.launches += 1
    return q, k, v


fused_ln_qkv_rope_fwd.launches = 0


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
    d = C // num_heads
    _check_widths(name, head_dim=d, C=C)
    if C != num_heads * d or tuple(w.shape) != (C, 3 * C):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"{num_heads} heads")
    _check(name, x.device, torch.bfloat16, x=x, w=w)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b=(b, (3 * C,)))
    q, k, v = (torch.empty((B, num_heads, N, d), dtype=x.dtype, device=x.device)
               for _ in range(3))
    if B and N:
        _kernels.launch(
            "sfm_fused_ln_qkv", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w.data_ptr(), b.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _row_stats_scratch(x).data_ptr(), B, N, num_heads, eps,
            _kernels.stream_ptr(x),
        )
        fused_ln_qkv_fwd.launches += 1
    return q, k, v


fused_ln_qkv_fwd.launches = 0


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
    if tuple(x_res.shape) != (B, N, C) or tuple(w.shape) != (C, C):
        raise ValueError(f"{name}: o {tuple(o.shape)}, x {tuple(x_res.shape)}, "
                         f"w {tuple(w.shape)}")
    _check(name, x_res.device, torch.bfloat16, x_res=x_res, o=o, w=w)
    _check(name, x_res.device, torch.float32, b=(b, (C,)), ls_gamma=(ls_gamma, (C,)))
    y = torch.empty_like(x_res)
    if B and N:
        _kernels.launch(
            "sfm_fused_proj_residual", o.data_ptr(), x_res.data_ptr(), w.data_ptr(),
            b.data_ptr(), ls_gamma.data_ptr(), y.data_ptr(), B, N, nh,
            _kernels.stream_ptr(x_res),
        )
        fused_proj_residual_fwd.launches += 1
    return y


fused_proj_residual_fwd.launches = 0


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
    _check_widths(name, C=C, hidden=Ch)
    if tuple(w1.shape) != (C, Ch):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 {tuple(w1.shape)}")
    _check(name, x.device, torch.bfloat16, x=x, w1=w1)
    _check(name, x.device, torch.float32, ln_scale=(ln_scale, (C,)), ln_bias=(ln_bias, (C,)),
               b1=(b1, (Ch,)))
    h = torch.empty((B, N, Ch), dtype=x.dtype, device=x.device)
    if B and N:
        _kernels.launch(
            "sfm_fused_mlp_up", x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            w1.data_ptr(), b1.data_ptr(), h.data_ptr(),
            _row_stats_scratch(x).data_ptr(), B * N, C, Ch, eps,
            _kernels.stream_ptr(x),
        )
        fused_mlp_up.launches += 1
    return h


fused_mlp_up.launches = 0


def fused_mlp_down(h, x, w2, b2, ls_gamma):
    """y = x + layer_scale(fc2(h)), h: (B, N, Ch), x: (B, N, C)."""
    _check_no_grad("fused_mlp_down", h, x, w2, b2, ls_gamma)
    if x.device.type == "cpu":
        return fused_mlp_down_plain(h, x, w2, b2, ls_gamma)
    name = "fused_mlp_down"
    B, N, C = x.shape
    Ch = h.shape[-1]
    _check_widths(name, C=C, hidden=Ch)
    if tuple(h.shape) != (B, N, Ch) or tuple(w2.shape) != (Ch, C):
        raise ValueError(f"{name}: h {tuple(h.shape)}, x {tuple(x.shape)}, "
                         f"w2 {tuple(w2.shape)}")
    _check(name, x.device, torch.bfloat16, x=x, h=h, w2=w2)
    _check(name, x.device, torch.float32, b2=(b2, (C,)), ls_gamma=(ls_gamma, (C,)))
    y = torch.empty_like(x)
    if B and N:
        _kernels.launch(
            "sfm_fused_mlp_down", h.data_ptr(), x.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), ls_gamma.data_ptr(), y.data_ptr(), B * N, Ch, C,
            _kernels.stream_ptr(x),
        )
        fused_mlp_down.launches += 1
    return y


fused_mlp_down.launches = 0


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
