"""Pre-LN transformer block: Attn+LayerScale residual, MLP+LayerScale residual.

Port of ``self_supervise_sfm_tpu/layers/block.py`` (forward only). The
block is composed of two halves, :func:`qkv_parts` and
:func:`attn_out_mlp`, the seam where the fused LN+QKV(+qk-norm+RoPE),
out-proj and MLP kernels (``ops/fused_qkv.py``) plug in.

``BlockConfig.fused_qkv`` / ``fused_mlp`` are the JAX package's tri-state:
``"auto"`` takes the fused route when ``x`` is bf16, the block's structure
qualifies and the kernel takes the block's widths (any width on the CPU,
whose wrappers run the plain versions; see the gates below), ``"on"`` drops
the dtype and width conditions: the kernels run in bf16 or in fp32 (each
has a form in either; at head dim 128 in bf16 only), and a width or head
dim they refuse meets their refusal;
``"off"`` runs the unfused chain of plain matmuls. The gates
decide by stated conditions; a fused wrapper never falls back. There is no
mesh condition: under a mesh the blocks run on rank-local shards
(``parallel/sp_block.py``), so a kernel never sees a sharded tensor, where
JAX's gate turns the kernels off because a ``pallas_call`` is opaque to
GSPMD. There is none on the weights' size either (the JAX gate's VMEM bound
belongs to the TPU).

``BlockConfig.drop_path`` is stochastic depth: with a rate above 0 and a
``drop_generator`` given to :func:`block`, each residual branch is scaled
by its own per-sample mask (:func:`drop_path_mask`), on the unfused chain.

The sharded variants of the JAX package's ``parallel/sp_block.py`` are
the port's ``parallel/sp_block.py``: they cut a rank's shard and run
:func:`block` / :func:`block_with_context` (or :func:`qkv_parts`, the ring
and :func:`attn_out_mlp`) on it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from . import params as P
from ..ops import fused_qkv as FQ
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
    # fused LN+QKV(+qk-norm+rope) / out-proj kernels: "auto" | "on" | "off"
    fused_qkv: str = "auto"
    # fused LN2+fc1+GELU / fc2+layer-scale+residual kernels, same tri-state
    fused_mlp: str = "auto"
    # stochastic-depth rate; it takes effect only when block() is also given a
    # drop_generator (no shipped configuration enables it)
    drop_path: float = 0.0

    def __post_init__(self):
        for name in ("fused_qkv", "fused_mlp"):
            val = getattr(self, name)
            if val not in ("auto", "on", "off"):
                raise ValueError(
                    f"{name} must be 'auto', 'on' or 'off', got {val!r}")

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


def drop_path_mask(generator: torch.Generator, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Per-sample stochastic-depth mask, Bernoulli(1 - rate) on the leading
    axis, broadcast over the others and scaled by 1 / (1 - rate) in x's
    dtype (the JAX package's ``drop_path_mask``; the draw comes from
    ``generator``, since torch cannot replay ``jax.random``)."""
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.dim() - 1)
    m = torch.rand(shape, generator=generator, device=x.device) < keep
    return m.to(x.dtype) / torch.tensor(keep, dtype=x.dtype, device=x.device)


def _fused_wanted(mode: str, x: torch.Tensor, widths_taken: bool) -> bool:
    """The tri-state: "off" never, "on" always, "auto" for a bf16 ``x`` at
    widths the kernel takes (every width on the CPU, as ``kernel_takes``).
    "on" reaches the wrapper in either dtype, whose kernels take head dim 64
    or 128 in bf16 and in fp32 and raise at any other on the card."""
    if mode == "on":
        return True
    return (mode == "auto" and x.dtype == torch.bfloat16
            and (x.device.type == "cpu" or widths_taken))


def local_heads(p, cfg: BlockConfig) -> int:
    """The heads whose q, k and v the block's qkv weight computes: all of
    ``cfg.num_heads``, or under tensor parallelism one rank's head shard
    (a (C, 3 Hl d) weight, ``parallel/sharding.py``'s per-head cut)."""
    return p["attn"]["qkv"]["w"].shape[-1] // (3 * (cfg.dim // cfg.num_heads))


def local_attn_cfg(p, cfg: BlockConfig) -> AttentionConfig:
    """``cfg.attn`` for the heads the block's weights compute: their head
    dim stays the whole width's."""
    hl = local_heads(p, cfg)
    if hl == cfg.num_heads:
        return cfg.attn
    return replace(cfg.attn, dim=hl * (cfg.dim // cfg.num_heads), num_heads=hl)


def _qkv_takes(p, cfg: BlockConfig) -> bool:
    """Whether LN+QKV(+RoPE) takes the block: the input width C and the
    local head count apart (a head shard's weight is (C, 3 Hl d))."""
    return FQ.qkv_kernel_takes(cfg.dim, local_heads(p, cfg), cfg.dim // cfg.num_heads)


def _fused_qkv_applicable(p, cfg: BlockConfig, x, rope_cos_sin) -> bool:
    """Gate of the fused LN+QKV+qk-norm+RoPE kernel: qk-norm on, a qkv bias,
    2D rope with shared (N, d) tables and a rope-compatible head dim."""
    if not _fused_wanted(cfg.fused_qkv, x, _qkv_takes(p, cfg)):
        return False
    if rope_cos_sin is None or rope_cos_sin[0].dim() != 2:
        return False
    if not (cfg.qk_norm and "b" in p["attn"]["qkv"]):
        return False
    return cfg.dim % cfg.num_heads == 0 and (cfg.dim // cfg.num_heads) % 4 == 0


def _fused_qkv_plain_applicable(p, cfg: BlockConfig, x) -> bool:
    """Gate of the fused LN+QKV without qk-norm and rope (the ViT blocks)."""
    if not _fused_wanted(cfg.fused_qkv, x, _qkv_takes(p, cfg)):
        return False
    if cfg.qk_norm or "b" not in p["attn"]["qkv"]:
        return False
    return cfg.dim % cfg.num_heads == 0


def _fused_proj_applicable(p, cfg: BlockConfig, x) -> bool:
    return (_fused_wanted(cfg.fused_qkv, x, FQ.proj_kernel_takes(cfg.dim, cfg.num_heads))
            and "b" in p["attn"]["proj"])


def _fused_mlp_applicable(p, cfg: BlockConfig, x) -> bool:
    if not _fused_wanted(cfg.fused_mlp, x, FQ.mlp_kernel_takes(cfg.dim, cfg.mlp_hidden)):
        return False
    return "fc1" in p["mlp"] and "b" in p["mlp"]["fc1"]


def qkv_parts(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """Per-head (q, k, v) after LN1 (+ qk-norm / rope), fused when applicable:
    (B, Hl, N, d) for the Hl heads of the block's qkv weight (all heads, or
    a rank's head shard; x is whole-width either way)."""
    n1, qkv = p["norm1"], p["attn"]["qkv"]
    hl = local_heads(p, cfg)
    if _fused_qkv_applicable(p, cfg, x, rope_cos_sin):
        cos, sin = rope_cos_sin
        qn, kn = p["attn"]["q_norm"], p["attn"]["k_norm"]
        return FQ.fused_ln_qkv_rope(
            x.contiguous(), n1["scale"], n1["bias"], qkv["w"], qkv["b"],
            qn["scale"], qn["bias"], kn["scale"], kn["bias"], cos, sin,
            hl, cfg.ln_eps,
        )
    if rope_cos_sin is None and _fused_qkv_plain_applicable(p, cfg, x):
        return FQ.fused_ln_qkv(x.contiguous(), n1["scale"], n1["bias"], qkv["w"],
                               qkv["b"], hl, cfg.ln_eps)
    h = P.layer_norm(n1, x, cfg.ln_eps)
    return qkv_heads(p["attn"], h, local_attn_cfg(p, cfg), rope_cos_sin)


def _mlp_residual(p, x, cfg: BlockConfig):
    """LN2 + MLP + layer-scale + residual, fused when applicable."""
    if _fused_mlp_applicable(p, cfg, x):
        fc1, fc2 = p["mlp"]["fc1"], p["mlp"]["fc2"]
        return FQ.fused_mlp_residual(
            x.contiguous(), p["norm2"]["scale"], p["norm2"]["bias"], fc1["w"],
            fc1["b"], fc2["w"], fc2["b"], p["ls2"]["gamma"], cfg.ln_eps,
        )
    h = P.layer_norm(p["norm2"], x, cfg.ln_eps)
    return x + P.layer_scale(p["ls2"], mlp(p["mlp"], h))


def attn_out_mlp(p, o: torch.Tensor, x: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """Head merge + out-proj + layer-scale + residual, then the MLP residual."""
    if _fused_proj_applicable(p, cfg, x):
        proj = p["attn"]["proj"]
        x = FQ.fused_proj_residual(o.contiguous(), x.contiguous(), proj["w"],
                                   proj["b"], p["ls1"]["gamma"])
    else:
        x = x + P.layer_scale(p["ls1"], P.linear(p["attn"]["proj"], _merge_heads(o)))
    return _mlp_residual(p, x, cfg)


def remat_call(on: bool, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` (non-reentrant) when
    ``on`` and grad mode is on: the JAX package's ``jax.checkpoint`` of a
    layer or block. The backward runs its forward again, kernels included."""
    if on and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def block(
    p, x, cfg: BlockConfig, rope_cos_sin=None, mask=None,
    extra_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    drop_generator: Optional[torch.Generator] = None,
):
    q, k, v = qkv_parts(p, x, cfg, rope_cos_sin)
    o = attention_heads_out(p["attn"], q, k, v, cfg.attn, mask, extra_kv)
    if cfg.drop_path > 0.0 and drop_generator is not None:
        # stochastic depth (training): plain residuals, each branch scaled by
        # a mask of its own, two draws as the JAX package's two keys
        attn_res = P.layer_scale(p["ls1"], P.linear(p["attn"]["proj"], _merge_heads(o)))
        x = x + drop_path_mask(drop_generator, x, cfg.drop_path) * attn_res
        h = P.layer_norm(p["norm2"], x, cfg.ln_eps)
        mlp_res = P.layer_scale(p["ls2"], mlp(p["mlp"], h))
        return x + drop_path_mask(drop_generator, x, cfg.drop_path) * mlp_res
    return attn_out_mlp(p, o, x, cfg)


def block_with_context(p, x, context, cfg: BlockConfig, rope_q=None, rope_ctx=None,
                       mask=None):
    """Block where ``context`` tokens contribute keys/values only. The
    context K/V stay on the unfused chain, as in the JAX package: their rope
    tables are 3-D (B, Nc, d) and do not qualify for the fused kernel."""
    ekv = block_context_kv(p, context, cfg, rope_ctx)
    return block(p, x, cfg, rope_q, mask, extra_kv=ekv)


def block_context_kv(p, context, cfg: BlockConfig, rope_ctx=None):
    """The (k, v) heads this block would derive from ``context`` tokens:
    what the relocalisation scene cache stores (post-norm, post-rope K/V),
    for the heads of the block's qkv weight (a rank's head shard under
    tensor parallelism). On the unfused chain, like
    :func:`block_with_context`."""
    hc = P.layer_norm(p["norm1"], context, cfg.ln_eps)
    return kv_heads(p["attn"], hc, local_attn_cfg(p, cfg), rope_ctx)
