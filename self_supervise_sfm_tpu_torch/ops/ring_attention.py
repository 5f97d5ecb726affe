"""Ring attention: sequence-parallel self-attention over the ``context`` axis.

Port of ``self_supervise_sfm_tpu/ops/ring_attention.py``. K/V stay sharded:
each rank holds N/n tokens of q, k and v, and the K/V chunks rotate around
the ring (``parallel/sharding.py:post_ring_shift``, one ``batch_isend_irecv``
a step) while each rank folds the visiting chunk into an exact online
softmax. The next step's exchange is posted before the current chunk's
attention runs, so the two overlap, as the scan body's ``ppermute`` and
attention do under XLA.

Numerics: a partial softmax (out_c, lse_c) per chunk, K1 through
``flash_attention_lse`` on the card and fp32 dense attention elsewhere (the
JAX package's off-TPU choice), merged in fp32 as

    L   = logsumexp_c(lse_c)
    out = sum_c out_c * exp(lse_c - L)

which is the softmax over the whole key axis; the result is cast to q's
dtype once, at the end. The backward comes out of autograd: through K1's lse
cotangent (B9 takes it as ``dlse``), through the merges and through the
rotation's reverse.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.sharding import (
    CONTEXT_AXIS, DATA_AXIS, Mesh, active_mesh, gather, post_ring_shift, scatter,
)
from . import flash_attention as fa


def _dense_chunk(q, k, v, scale: float):
    """Partial softmax against one key chunk, fp32: (out fp32, lse fp32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return out, (m + torch.log(l))[..., 0]


def _use_flash(q, k, v, impl: str = "auto") -> bool:
    """K1 on the card wherever the kernel takes the site (``kernel_takes``:
    a forward form of K1 and, under grad, its backward B9 in the same dtype:
    head dim 64 or 128 in bf16 or fp32); the dense chunk on the CPU, for the
    other sites and under ``"dense"``."""
    return impl != "dense" and q.device.type != "cpu" and fa.kernel_takes(q, k, v)


def _chunk_attn(q, k, v, use_flash: bool):
    if use_flash:
        out, lse = fa.flash_attention_lse(q, k, v)
        return out.float(), lse
    return _dense_chunk(q, k, v, q.shape[-1] ** -0.5)


def _merge(o_a, lse_a, o_b, lse_b):
    """Combine two partial softmaxes (fp32 outputs and natural-log lse) into
    one: the exact softmax over the union of their key sets."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    out = (o_a * wa + o_b * wb) / (wa + wb)
    lse = m + torch.log(wa + wb)[..., 0]
    return out, lse


def ring_applicable(q, mesh: Optional[Mesh], mask) -> bool:
    """The ring's preconditions: a mesh with a context extent above 1 that
    divides the token axis, and no attention mask (the global-attention site
    is unmasked; masked sites keep the flash and dense paths)."""
    if mask is not None or mesh is None:
        return False
    n = mesh.shape.get(CONTEXT_AXIS, 1)
    return n > 1 and q.dim() == 4 and q.shape[2] % n == 0


def ring_attention_local(q, k, v, mesh: Mesh, impl: str = "auto"):
    """The ring on this rank's shards: q, k, v (B, H, N/n, d), the rank's
    chunk of the token axis in the order of the ``context`` axis ->
    (B, H, N/n, d) in q's dtype."""
    n = mesh.size(CONTEXT_AXIS)
    use_flash = _use_flash(q, k, v, impl)
    if n > 1:
        (kn, vn), wait = post_ring_shift(mesh, CONTEXT_AXIS, k, v)
    o, lse = _chunk_attn(q, k, v, use_flash)
    for step in range(1, n):
        wait()
        kc, vc = kn, vn
        if step < n - 1:
            (kn, vn), wait = post_ring_shift(mesh, CONTEXT_AXIS, kc, vc)
        o_c, lse_c = _chunk_attn(q, kc, vc, use_flash)
        o, lse = _merge(o, lse, o_c, lse_c)
    return o.to(q.dtype)


def ring_fold(q, k, v, n: int, use_flash: Optional[bool] = None):
    """The ring's fold in one process: q against the ``n`` chunks of k / v's
    token axis in the order rank 0 of an n-rank ring meets them (its own
    chunk, then chunks n-1, n-2, ..., 1), merged as :func:`ring_attention_local`
    merges them. Needs no process group."""
    if k.shape[2] % n:
        raise ValueError(f"{k.shape[2]} keys do not split into {n} chunks")
    if use_flash is None:
        use_flash = _use_flash(q, k, v)
    ks, vs = k.chunk(n, dim=2), v.chunk(n, dim=2)
    o, lse = _chunk_attn(q, ks[0].contiguous(), vs[0].contiguous(), use_flash)
    for c in range(n - 1, 0, -1):
        o_c, lse_c = _chunk_attn(q, ks[c].contiguous(), vs[c].contiguous(), use_flash)
        o, lse = _merge(o, lse, o_c, lse_c)
    return o.to(q.dtype)


def ring_sdpa(q, k, v, mesh: Optional[Mesh] = None):
    """Sequence-parallel SDPA on whole tensors: (B, H, N, d)^3 -> (B, H, N,
    d), every rank holding all of q, k, v. The token axis is cut over
    ``context`` (the batch over ``data`` when it divides), each rank rides
    the ring with its chunk, and the output is gathered whole.

    Caller guarantees :func:`ring_applicable`."""
    mesh = mesh if mesh is not None else active_mesh()
    nd = mesh.size(DATA_AXIS)
    by_data = nd > 1 and q.shape[0] % nd == 0

    def cut(x):
        if by_data:
            x = scatter(x, mesh, DATA_AXIS, 0)
        return scatter(x, mesh, CONTEXT_AXIS, 2)

    o = ring_attention_local(cut(q), cut(k), cut(v), mesh)
    o = gather(o, mesh, CONTEXT_AXIS, 2)
    return gather(o, mesh, DATA_AXIS, 0) if by_data else o
