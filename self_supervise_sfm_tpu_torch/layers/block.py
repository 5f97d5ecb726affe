"""Pre-LN transformer block: Attn+LayerScale residual, MLP+LayerScale residual.

Port of ``self_supervise_sfm_tpu/layers/block.py`` (forward only). The
block is composed of two halves, :func:`qkv_parts` and
:func:`attn_out_mlp`, the seam where the fused LN+QKV(+RoPE), out-proj and
MLP kernels plug in. Those kernels belong to the next slice of the port:
``fused_qkv`` / ``fused_mlp`` stay "off" here and the block runs as plain
matmuls, which is what the JAX package computes off the TPU.

No sharding: on one device the JAX package's ``parallel/sp_block.py``
variants reduce to :func:`block` / :func:`block_with_context`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import params as P
from .attention import (
    AttentionConfig, _merge_heads, attention_heads_out, init_attention,
    kv_heads, qkv_heads,
)


@dataclass(frozen=True)
class BlockConfig:
    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    qk_norm: bool = False
    ln_eps: float = 1e-5
    init_values: float = 0.01
    attn_impl: str = "auto"
    # fused LN+QKV(+qk-norm+rope) / out-proj kernels: "off" | "on"
    fused_qkv: str = "off"
    # fused LN2+fc1+GELU / fc2+layer-scale+residual kernels: "off" | "on"
    fused_mlp: str = "off"

    def __post_init__(self):
        for name in ("fused_qkv", "fused_mlp"):
            val = getattr(self, name)
            if val == "on":
                raise NotImplementedError(
                    f"{name}='on': the fused LN/QKV/proj/MLP kernels are the "
                    "next slice of the port"
                )
            if val != "off":
                raise ValueError(f"{name} must be 'off' or 'on', got {val!r}")

    @property
    def attn(self) -> AttentionConfig:
        return AttentionConfig(
            dim=self.dim, num_heads=self.num_heads, qk_norm=self.qk_norm,
            ln_eps=self.ln_eps, impl=self.attn_impl,
        )

    @property
    def mlp_hidden(self) -> int:
        return int(self.dim * self.mlp_ratio)


def init_block(g, device, cfg: BlockConfig):
    return {
        "norm1": P.init_layer_norm(cfg.dim, device),
        "attn": init_attention(g, device, cfg.attn),
        "ls1": P.init_layer_scale(cfg.dim, cfg.init_values, device),
        "norm2": P.init_layer_norm(cfg.dim, device),
        "mlp": {
            "fc1": P.init_linear(g, device, cfg.dim, cfg.mlp_hidden),
            "fc2": P.init_linear(g, device, cfg.mlp_hidden, cfg.dim),
        },
        "ls2": P.init_layer_scale(cfg.dim, cfg.init_values, device),
    }


def mlp(p, x):
    return P.linear(p["fc2"], P.gelu(P.linear(p["fc1"], x)))


def qkv_parts(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """Per-head (q, k, v) after LN1 (+ qk-norm / rope)."""
    h = P.layer_norm(p["norm1"], x, cfg.ln_eps)
    return qkv_heads(p["attn"], h, cfg.attn, rope_cos_sin)


def attn_out_mlp(p, o: torch.Tensor, x: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """Head merge + out-proj + layer-scale + residual, then the MLP residual."""
    x = x + P.layer_scale(p["ls1"], P.linear(p["attn"]["proj"], _merge_heads(o)))
    h = P.layer_norm(p["norm2"], x, cfg.ln_eps)
    return x + P.layer_scale(p["ls2"], mlp(p["mlp"], h))


def block(
    p, x, cfg: BlockConfig, rope_cos_sin=None, mask: Optional[torch.Tensor] = None,
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
):
    q, k, v = qkv_parts(p, x, cfg, rope_cos_sin)
    o = attention_heads_out(p["attn"], q, k, v, cfg.attn, mask, extra_kv)
    return attn_out_mlp(p, o, x, cfg)


def block_with_context(p, x, context, cfg: BlockConfig, rope_q=None, rope_ctx=None,
                       mask=None):
    """Block where ``context`` tokens contribute keys/values only."""
    hc = P.layer_norm(p["norm1"], context, cfg.ln_eps)
    ekv = kv_heads(p["attn"], hc, cfg.attn, rope_ctx)
    return block(p, x, cfg, rope_q, mask, extra_kv=ekv)
