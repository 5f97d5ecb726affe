"""Parameter primitives: init + apply for linear / layer norm / conv.

Port of ``self_supervise_sfm_tpu/layers/params.py``. Parameters are plain
dicts of tensors, as in the JAX package, and every apply function keeps its
rounding points:

- Linear: ``{'w': (d_in, d_out), 'b': (d_out,)}``; ``x @ w`` in x's dtype,
  then the bias added in x's dtype.
- LayerNorm: ``{'scale', 'bias'}``; statistics in fp32, result cast back.
- Conv2d: NHWC activations as in JAX; the weight is stored OIHW (PyTorch's
  own layout, converted once from HWIO by ``convert.py``) and transposed
  conv weights ``(in, out, kh, kw)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def trunc_normal(shape, generator, device, std=0.02):
    """std * N(0, 1) truncated to [-2, 2], as ``jax.random.truncated_normal``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=generator)
    return t


def normal(shape, generator, device, std=1.0):
    return std * torch.randn(shape, generator=generator, device=device)


# -- linear -------------------------------------------------------------------


def init_linear(g, device, d_in: int, d_out: int, bias: bool = True, std: float = 0.02):
    p = {"w": trunc_normal((d_in, d_out), g, device, std)}
    if bias:
        p["b"] = torch.zeros((d_out,), device=device)
    return p


def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -- layer norm ---------------------------------------------------------------


def init_layer_norm(d: int, device, affine: bool = True):
    if not affine:
        return {}
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layer_norm(p, x, eps: float = 1e-5):
    """Always computed in fp32; result cast back to the input dtype."""
    y = F.layer_norm(
        x.float(), x.shape[-1:], p.get("scale"), p.get("bias"), eps
    )
    return y.to(x.dtype)


# -- conv2d (NHWC activations, OIHW weights) ----------------------------------


def init_conv(g, device, kh: int, kw: int, c_in: int, c_out: int, bias: bool = True):
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    p = {"w": normal((c_out, c_in, kh, kw), g, device, std)}
    if bias:
        p["b"] = torch.zeros((c_out,), device=device)
    return p


def _padding(padding, kh: int, kw: int, stride):
    if padding == "VALID":
        return (0, 0)
    if padding == "SAME":
        if stride != (1, 1) or kh % 2 == 0 or kw % 2 == 0:
            raise ValueError("SAME padding is ported for stride 1, odd kernels")
        return (kh // 2, kw // 2)
    (t, b), (l, r) = padding
    if t != b or l != r:
        raise ValueError(f"asymmetric padding {padding}")
    return (t, l)


def conv2d(p, x, stride=1, padding="SAME", accum_dtype: Optional[torch.dtype] = None):
    """x: (N, H, W, C_in) -> (N, H', W', C_out).

    ``accum_dtype``: as JAX's ``preferred_element_type``. A bf16 input with
    fp32 accumulation multiplies the bf16-rounded weights and inputs exactly
    and sums in fp32 — computed here as an fp32 conv of the bf16 values.
    """
    if isinstance(stride, int):
        stride = (stride, stride)
    w = p["w"].to(x.dtype)
    if accum_dtype is not None and accum_dtype != x.dtype:
        x, w = x.to(accum_dtype), w.to(accum_dtype)
    pad = _padding(padding, w.shape[2], w.shape[3], stride)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def init_conv_transpose(g, device, kh: int, kw: int, c_in: int, c_out: int,
                        bias: bool = True):
    std = (2.0 / (kh * kw * c_in)) ** 0.5
    p = {"w": normal((c_in, c_out, kh, kw), g, device, std)}
    if bias:
        p["b"] = torch.zeros((c_out,), device=device)
    return p


def conv_transpose2d(p, x, stride):
    """``ConvTranspose2d(..., padding=0)`` on NHWC x; kernel == stride in the DPT."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p["w"].to(x.dtype), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# -- misc ---------------------------------------------------------------------


def gelu(x):
    """Exact (erf) GELU."""
    return F.gelu(x, approximate="none")


def layer_scale(p, x):
    return x * p["gamma"].to(x.dtype)


def init_layer_scale(d: int, init_value: float, device):
    return {"gamma": torch.full((d,), init_value, device=device)}
