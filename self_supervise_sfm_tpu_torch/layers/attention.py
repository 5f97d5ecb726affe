"""Multi-head attention with fused QKV, optional QK-norm / 2D RoPE / extra KV.

Port of ``self_supervise_sfm_tpu/layers/attention.py``. The scene context
enters as an explicit extra (k, v) pair prepended to the fresh keys.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import params as P
from . import rope as R
from ..ops import attention_core
from ..ops import flash_attention as fa


@dataclass(frozen=True)
class AttentionConfig:
    dim: int
    num_heads: int
    qk_norm: bool = False
    ln_eps: float = 1e-5
    impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads


def init_attention(g, device, cfg: AttentionConfig):
    p = {
        "qkv": P.init_linear(g, device, cfg.dim, 3 * cfg.dim),
        "proj": P.init_linear(g, device, cfg.dim, cfg.dim),
    }
    if cfg.qk_norm:
        p["q_norm"] = P.init_layer_norm(cfg.head_dim, device)
        p["k_norm"] = P.init_layer_norm(cfg.head_dim, device)
    return p


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C = x.shape
    return x.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


def qkv_heads(p, x, cfg: AttentionConfig, rope_cos_sin=None):
    """Project x to per-head (q, k, v) with qk-norm and rope applied."""
    qkv = P.linear(p["qkv"], x)
    q, k, v = (_split_heads(t, cfg.num_heads) for t in qkv.chunk(3, dim=-1))
    if cfg.qk_norm:
        q = P.layer_norm(p["q_norm"], q, cfg.ln_eps)
        k = P.layer_norm(p["k_norm"], k, cfg.ln_eps)
    if rope_cos_sin is not None:
        cos, sin = rope_cos_sin
        q = R.apply_rope(q, cos, sin)
        k = R.apply_rope(k, cos, sin)
    return q, k, v


def kv_heads(p, x, cfg: AttentionConfig, rope_cos_sin=None):
    """K/V-only projection through slices of the fused QKV weight."""
    w = p["qkv"]["w"]
    D = w.shape[-1] // 3
    k = x @ w[:, D: 2 * D].to(x.dtype)
    v = x @ w[:, 2 * D:].to(x.dtype)
    if "b" in p["qkv"]:
        b = p["qkv"]["b"]
        k = k + b[D: 2 * D].to(x.dtype)
        v = v + b[2 * D:].to(x.dtype)
    k = _split_heads(k, cfg.num_heads)
    v = _split_heads(v, cfg.num_heads)
    if cfg.qk_norm:
        k = P.layer_norm(p["k_norm"], k, cfg.ln_eps)
    if rope_cos_sin is not None:
        cos, sin = rope_cos_sin
        k = R.apply_rope(k, cos, sin)
    return k, v


def attention_heads_out(
    p, q, k, v, cfg: AttentionConfig, mask=None,
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    """The attention core alone: (B, H, N, d) per-head outputs. ``mask`` is
    a boolean tensor, a ``RelocMask`` or None. Under ``impl="auto"`` a site
    the attention kernels do not take (fp32 or head dim other than 64 on the
    card, ``fa.kernel_takes``) runs dense; ``impl="flash"`` reaches the
    kernels and their refusal."""
    if extra_kv is not None and extra_kv[0].shape[0] != q.shape[0]:
        # frame-major reloc layout: q/k/v carry (B*F, H, P, d) with frames
        # folded into batch while the shared context K/V stays (B, H, Nc, d);
        # every q row sees [ctx ‖ own frame], the allow-mask by layout
        if mask is not None or q.shape[0] % extra_kv[0].shape[0]:
            raise ValueError("frame-major context attention takes no mask")
        ek, ev = extra_kv
        if (
            cfg.impl != "dense"
            and cfg.head_dim <= 256
            and (cfg.impl == "flash"
                 or (fa.kernel_takes(q, k, v)
                     and q.shape[2] * (ek.shape[2] + k.shape[2]) >= 1_500_000))
        ):
            return fa.frame_ctx_attention(q, k, v, ek, ev)
        return fa._frame_ctx_dense(q, k, v, ek.to(k.dtype), ev.to(v.dtype))
    o = None
    if (
        extra_kv is not None
        and isinstance(mask, attention_core.RelocMask)
        and cfg.impl != "dense"
        and (cfg.impl == "flash" or fa.kernel_takes(q, k, v))
        and q.shape[2] * (mask.n_ctx + mask.frame_size) >= 1_500_000
    ):
        # [ctx ‖ own frame] mask structure: two unmasked flash calls merged
        # by lse (see reloc_split_attention)
        ek, ev = extra_kv
        o = attention_core.reloc_split_attention(
            q, k, v, ek.to(k.dtype), ev.to(v.dtype), mask)
    if o is None:
        if extra_kv is not None:
            ek, ev = extra_kv
            k = torch.cat([ek.to(k.dtype), k], dim=2)
            v = torch.cat([ev.to(v.dtype), v], dim=2)
        o = attention_core.sdpa(q, k, v, mask=mask, impl=cfg.impl)
    return o
