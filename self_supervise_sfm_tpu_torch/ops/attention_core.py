"""Scaled-dot-product attention cores.

Port of ``self_supervise_sfm_tpu/ops/attention_core.py``: ``sdpa_dense`` is
einsum attention with fp32 logits and softmax (not PyTorch's
``scaled_dot_product_attention``); ``sdpa`` dispatches to the flash kernel
wrapper behind the JAX package's ``worth_it`` gate, or to the ring
(``ops/ring_attention.py``) under ``impl="ring"``. A mask is a boolean
tensor (True = attend), a :class:`RelocMask` spec (materialised for the dense
path, evaluated per element by the flash kernel) or None.
"""

from __future__ import annotations

import torch

from . import flash_attention as fa
from .mask_spec import RelocMask
from .ring_attention import _merge

_NEG_INF = -1e30


def sdpa_dense(q, k, v, mask=None):
    """Dense attention. q,k,v: (B, H, N, d); mask broadcastable (B|1, 1, Nq, Nk)."""
    if isinstance(mask, RelocMask):
        mask = mask.materialize(q.device)
    d = q.shape[-1]
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d**-0.5
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, _NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def reloc_split_attention(q, k_self, v_self, k_ctx, v_ctx, mask: RelocMask):
    """RelocMask attention as two unmasked flash calls merged by log-sum-exp.

    Every query row sees [all context ‖ its own frame], which partitions the
    key axis, so softmax(q, [ctx ‖ own]) == lse-merge(softmax(q, ctx),
    softmax(q, own)): no per-element mask and no dead key tiles. Returns
    None when the shapes do not line up with the mask (the caller then takes
    the masked path).
    """
    B, H, N, d = q.shape
    F, P = mask.num_frames, mask.frame_size
    if N != F * P or k_self.shape[2] != N or k_ctx.shape[2] != mask.n_ctx:
        return None
    o_ctx, lse_ctx = fa.flash_attention_lse(q, k_ctx, v_ctx)

    # own-frame part: frames fold into the batch axis, plain per-frame
    # self-attention with no mask at all
    def fold(x):
        return x.reshape(B, H, F, P, d).transpose(1, 2).reshape(B * F, H, P, d)

    o_s, lse_s = fa.flash_attention_lse(fold(q), fold(k_self), fold(v_self))
    o_s = o_s.reshape(B, F, H, P, d).transpose(1, 2).reshape(B, H, N, d)
    lse_s = lse_s.reshape(B, F, H, P).transpose(1, 2).reshape(B, H, N)
    out, _ = _merge(o_ctx.float(), lse_ctx, o_s.float(), lse_s)
    return out.to(q.dtype)


def sdpa(q, k, v, mask=None, impl: str = "auto"):
    """``impl``: 'dense' | 'flash' | 'auto' | 'ring' ('auto' takes flash when
    it pays and the kernels take the site, ``fa.worth_it``: on the card head
    dim 64 or 128 in bf16 or fp32, with or without a RelocMask,
    differentiated or not; any site on the CPU). A :class:`RelocMask` goes
    to the masked flash kernel; a boolean mask stays on the dense path.
    'ring' takes the ring over the active mesh's
    ``context`` axis where ``ring_applicable`` holds, else 'auto'."""
    if impl == "dense":
        return sdpa_dense(q, k, v, mask)
    if impl == "ring":
        from ..parallel.sharding import active_mesh
        from . import ring_attention as ra

        mesh = active_mesh()
        if ra.ring_applicable(q, mesh, mask):
            return ra.ring_sdpa(q, k, v, mesh)
        impl = "auto"  # no mesh, one context rank, or a non-dividing axis
    if impl in ("flash", "auto"):
        if fa.supported(q, k, v, mask) and (impl == "flash" or fa.worth_it(q, k, v)):
            return fa.flash_attention(
                q, k, v, mask if isinstance(mask, RelocMask) else None)
        return sdpa_dense(q, k, v, mask)
    raise ValueError(
        f"unknown attention impl: {impl!r} (one of 'dense', 'flash', 'auto', 'ring')")
