"""Flash attention (K1, K1m) and fused [context ‖ own frame] attention (K2, K2p).

Port of ``self_supervise_sfm_tpu/ops/flash_attention.py`` (forward only).
The Pallas TPU kernels become hand-written CUDA kernels in
``csrc/flash_attention.cu``; each sits beside its plain PyTorch version:

- :func:`flash_fwd` (K1) replaces ``_flash_fwd``/``_kernel``: online
  softmax in the log2 domain, fp32 state, p cast to v's dtype before PV,
  out in q's dtype plus the natural-log lse. Plain version
  :func:`flash_fwd_plain` repeats that arithmetic densely.
- :func:`flash_fwd_reloc` (K1m) is the same call under a
  :class:`~.mask_spec.RelocMask`: the allow predicate per element, key
  tiles no row of a block can see skipped. Plain version
  :func:`flash_fwd_plain` with the mask.
- :func:`frame_ctx_fwd` (K2) replaces ``frame_ctx_kernel``: each frame's
  rows attend one softmax over [shared context ‖ own frame]. Plain version
  :func:`_frame_ctx_dense`.
- :func:`frame_ctx_packed_fwd` (K2p) replaces ``frame_ctx_packed_kernel``:
  K2 with the context read in place from layer ``layer`` of the
  depth-stacked kv2 scene cache (depth, B, H, Nc, 2d), rows of [k ‖ v]. The
  wrapper hands the kernel the whole cache's pointer and the layer index
  and copies nothing of the cache. Plain version
  :func:`frame_ctx_packed_plain`.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises. The kernels are bound by the bf16
tensor-core rate at the main-path sizes (see the source notes in the
``.cu`` file) and take bf16, contiguous, d = 64 inputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from .mask_spec import RelocMask

NEG_INF = -1e30
LOG2E = 1.4426950408889634
KERNEL_HEAD_DIM = 64


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.shape[-1] != KERNEL_HEAD_DIM:
            raise ValueError(
                f"{name}: the kernel takes head dim {KERNEL_HEAD_DIM}, "
                f"got {t.shape[-1]}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


# -- K1: flash forward --------------------------------------------------------


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[RelocMask] = None):
    """Dense twin of the K1 / K1m kernels. q: (BH, Nq, d); k/v: (BH, Nk, d).

    Same arithmetic as the kernel, in one tile: fp32 logits scaled into the
    log2 domain, p = exp2(s - m) cast to v's dtype before PV with fp32
    accumulation, out = acc / l (l == 0 guarded) in q's dtype, and the
    natural-log lse = m / log2(e) + log(l). A ``mask`` is applied by select
    before the row max, as the kernel applies it.
    """
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5 * LOG2E)
    if mask is not None:
        _check_mask("flash_fwd_plain", mask, q.shape[1], k.shape[1])
        s = torch.where(mask.materialize(q.device)[0], s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)
    lse = (m * (1.0 / LOG2E) + torch.log(l_safe))[..., 0]
    return out, lse


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K1 wrapper: (BH, Nq, d) x (BH, Nk, d)^2 -> (out (BH, Nq, d), lse (BH, Nq) fp32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v)
    _check_cuda("flash_fwd", q, k, v)
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if k.shape != (BH, Nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes {q.shape} {k.shape} {v.shape}")
    out = torch.empty_like(q)
    lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    if BH and Nq:
        _kernels.launch(
            "sfm_flash_fwd_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), BH, Nq, Nk, d**-0.5 * LOG2E,
            _kernels.stream_ptr(q),
        )
        flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def _check_mask(name: str, mask: RelocMask, nq: int, nk: int) -> None:
    if mask.frame_size <= 0 or mask.n_ctx < 0 or mask.nq != nq or mask.nk != nk:
        raise ValueError(f"{name}: {mask} does not describe ({nq}, {nk}) logits")


def flash_fwd_reloc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: RelocMask):
    """K1m wrapper: :func:`flash_fwd` under a RelocMask. q: (BH, F*P, d);
    k/v: (BH, n_ctx + F*P, d), keys laid out [context ‖ frames]."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, mask)
    _check_cuda("flash_fwd_reloc", q, k, v)
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if k.shape != (BH, Nk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd_reloc: shapes {q.shape} {k.shape} {v.shape}")
    _check_mask("flash_fwd_reloc", mask, Nq, Nk)
    out = torch.empty_like(q)
    lse = torch.empty((BH, Nq), dtype=torch.float32, device=q.device)
    if BH and Nq:
        _kernels.launch(
            "sfm_flash_fwd_reloc_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), BH, Nq, Nk, mask.n_ctx,
            mask.frame_size, mask.num_frames, d**-0.5 * LOG2E,
            _kernels.stream_ptr(q),
        )
        flash_fwd_reloc.launches += 1
    return out, lse


flash_fwd_reloc.launches = 0


def flash_attention_lse(q, k, v, mask: Optional[RelocMask] = None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> ((B, H, Nq, d), (B, H, Nq) fp32 lse)."""
    if mask is not None and not isinstance(mask, RelocMask):
        raise TypeError(
            "the flash kernel takes a RelocMask or no mask; boolean masks "
            "stay on the dense path")
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    flat = (
        q.reshape(B * H, Nq, d).contiguous(),
        k.reshape(B * H, Nk, d).contiguous(),
        v.reshape(B * H, Nk, d).contiguous(),
    )
    out, lse = flash_fwd(*flat) if mask is None else flash_fwd_reloc(*flat, mask)
    return out.reshape(B, H, Nq, d), lse.reshape(B, H, Nq)


def flash_attention(q, k, v, mask: Optional[RelocMask] = None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> (B, H, Nq, d)."""
    return flash_attention_lse(q, k, v, mask)[0]


def supported(q, k, v, mask) -> bool:
    if mask is not None and not isinstance(mask, RelocMask):
        return False  # dense boolean masks stay on the dense path
    return q.shape[-1] <= 256 and q.dim() == 4


def worth_it(q, k, v) -> bool:
    # the JAX package's measured cut-over (``ops/flash_attention.py:814-817``)
    return q.shape[-2] * k.shape[-2] >= 1_500_000


# -- K2: fused [context ‖ own frame] attention --------------------------------


def _frame_ctx_dense(q, k, v, ck, cv):
    """Dense reference: per-frame softmax over the [ctx ‖ own] concatenation.

    q/k/v: (B*F, H, P, d) frame-major; ck/cv: (B, H, Nc, d) shared context.
    fp32 logits and softmax, probs cast to q's dtype before PV.
    """
    BF, H, P, d = q.shape
    B = ck.shape[0]
    F = BF // B

    def bcast(c):
        return c[:, None].expand(B, F, *c.shape[1:]).reshape(BF, *c.shape[1:])

    kk = torch.cat([bcast(ck).to(k.dtype), k], dim=2)
    vv = torch.cat([bcast(cv).to(v.dtype), v], dim=2)
    logits = torch.matmul(q.float(), kk.float().transpose(-1, -2)) * d**-0.5
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(q.dtype).float(), vv.float())
    return out.to(q.dtype)


def frame_ctx_fwd(q, k, v, ck, cv):
    """K2 wrapper. q/k/v: (B*F, H, P, d); ck/cv: (B, H, Nc, d) -> (B*F, H, P, d)."""
    if q.device.type == "cpu":
        return _frame_ctx_dense(q, k, v, ck, cv)
    _check_cuda("frame_ctx_fwd", q, k, v, ck, cv)
    BF, H, P, d = q.shape
    B, Hc, Nc, _ = ck.shape
    if (k.shape != q.shape or v.shape != q.shape or cv.shape != ck.shape
            or Hc != H or BF % B):
        raise ValueError(
            f"frame_ctx_fwd: shapes {q.shape} {k.shape} {v.shape} "
            f"{ck.shape} {cv.shape}"
        )
    out = torch.empty_like(q)
    if BF and P:
        _kernels.launch(
            "sfm_frame_ctx_fwd_bf16", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ck.data_ptr(), cv.data_ptr(), out.data_ptr(), BF, H, BF // B, P,
            Nc, d**-0.5 * LOG2E, _kernels.stream_ptr(q),
        )
        frame_ctx_fwd.launches += 1
    return out


frame_ctx_fwd.launches = 0


def frame_ctx_attention(q, k, v, ck, cv):
    """Fused reloc attention: frame-major q/k/v against shared context K/V."""
    return frame_ctx_fwd(
        q.contiguous(), k.contiguous(), v.contiguous(),
        ck.to(k.dtype).contiguous(), cv.to(v.dtype).contiguous(),
    )


# -- K2p: K2 against one layer of the kv2 scene cache, read in place ----------


def _check_packed(q, k, v, ckv, layer: int) -> None:
    """Shape, layout and range checks shared by the kernel and plain paths."""
    if q.dim() != 4 or ckv.dim() != 5:
        raise ValueError(
            f"frame_ctx_packed: q {tuple(q.shape)} must be (B*F, H, P, d) and "
            f"the cache {tuple(ckv.shape)} (depth, B, H, Nc, 2d)")
    BF, H, P, d = q.shape
    depth, B, Hc, Nc, d2 = ckv.shape
    if (k.shape != q.shape or v.shape != q.shape or Hc != H or d2 != 2 * d
            or B == 0 or BF % B):
        raise ValueError(
            f"frame_ctx_packed: shapes {tuple(q.shape)} {tuple(k.shape)} "
            f"{tuple(v.shape)} against the cache {tuple(ckv.shape)}")
    if not ckv.is_contiguous():
        raise ValueError(
            "frame_ctx_packed: the cache must be contiguous (it is read in "
            "place, never copied)")
    if not 0 <= layer < depth:
        raise IndexError(
            f"frame_ctx_packed: layer {layer} outside the cache's {depth} layers")


def frame_ctx_packed_plain(q, k, v, ckv, layer: int):
    """Plain version of K2p: slice layer ``layer``, split the [k ‖ v] rows,
    then :func:`_frame_ctx_dense`."""
    _check_packed(q, k, v, ckv, layer)
    d = q.shape[-1]
    ck, cv = ckv[layer, ..., :d], ckv[layer, ..., d:]
    return _frame_ctx_dense(q, k, v, ck.to(k.dtype), cv.to(v.dtype))


def frame_ctx_packed_fwd(q, k, v, ckv, layer: int):
    """K2p wrapper. q/k/v: (B*F, H, P, d); ckv: (depth, B, H, Nc, 2d), the
    whole stacked cache (or a segment of it); -> (B*F, H, P, d).

    The kernel gets ``ckv.data_ptr()``, ``layer`` and the layer stride: no
    slice, split or copy of cache data is made here, and the cache is never
    written."""
    if q.device.type == "cpu":
        return frame_ctx_packed_plain(q, k, v, ckv, layer)
    _check_packed(q, k, v, ckv, layer)
    _check_cuda("frame_ctx_packed_fwd", q, k, v)
    if ckv.device != q.device or ckv.dtype != torch.bfloat16:
        raise TypeError(
            f"frame_ctx_packed_fwd: the cache must be bfloat16 on {q.device}, "
            f"got {ckv.dtype} on {ckv.device}")
    if ckv.data_ptr() % 16:
        raise ValueError("frame_ctx_packed_fwd: the cache must be 16-byte aligned")
    BF, H, P, d = q.shape
    _, B, _, Nc, _ = ckv.shape
    out = torch.empty_like(q)
    if BF and P:
        _kernels.launch(
            "sfm_frame_ctx_kv2_fwd_bf16", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ckv.data_ptr(), out.data_ptr(), BF, H, BF // B, P, Nc,
            layer, B * H * Nc * 2 * d, d**-0.5 * LOG2E, _kernels.stream_ptr(q),
        )
        frame_ctx_packed_fwd.launches += 1
    return out


frame_ctx_packed_fwd.launches = 0


def packed_ctx_attention(q, k, v, ckv, layer: int, impl: str = "auto"):
    """[ctx ‖ own] reloc attention against one layer of the kv2 scene cache.

    The gate is the one of the frame-major context site in
    ``layers/attention.py``: the in-place kernel wrapper when ``impl`` is not
    "dense", the head dim is at most 256, and either ``impl == "flash"`` or
    ``P * (Nc + P) >= 1.5M`` (the JAX package's cut, without its TPU-backend
    condition; the wrapper itself takes its plain version for a CPU tensor
    only). Otherwise the layer is sliced and split and the dense reference
    runs."""
    d = q.shape[-1]
    Nc = ckv.shape[3]
    if (
        impl != "dense"
        and d <= 256
        and (impl == "flash" or q.shape[2] * (Nc + k.shape[2]) >= 1_500_000)
    ):
        return frame_ctx_packed_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), ckv, layer)
    ck, cv = ckv[layer, ..., :d], ckv[layer, ..., d:]
    return _frame_ctx_dense(q, k, v, ck.to(k.dtype), cv.to(v.dtype))
