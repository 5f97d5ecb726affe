"""Scaled-dot-product attention cores.

Port of ``self_supervise_sfm_tpu/ops/attention_core.py``: ``sdpa_dense`` is
einsum attention with fp32 logits and softmax (not PyTorch's
``scaled_dot_product_attention``); ``sdpa`` dispatches to the flash kernel
wrapper behind the JAX package's ``worth_it`` gate. Masks are boolean
(True = attend) or None; the ``RelocMask`` spec is not ported yet.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa

_NEG_INF = -1e30


def sdpa_dense(q, k, v, mask=None):
    """Dense attention. q,k,v: (B, H, N, d); mask broadcastable (B|1, 1, Nq, Nk)."""
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def sdpa(q, k, v, mask=None, impl: str = "auto"):
    """``impl``: 'dense' | 'flash' | 'auto' ('auto' takes flash when it pays)."""
    if impl == "dense":
        return sdpa_dense(q, k, v, mask)
    if impl in ("flash", "auto"):
        if fa.supported(q, k, v, mask) and (impl == "flash" or fa.worth_it(q, k, v)):
            return fa.flash_attention(q, k, v)
        return sdpa_dense(q, k, v, mask)
    raise ValueError(f"unknown attention impl: {impl}")
