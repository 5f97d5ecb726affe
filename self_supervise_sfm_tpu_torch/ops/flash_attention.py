"""Flash attention (K1) and fused [context ‖ own frame] attention (K2).

Port of ``self_supervise_sfm_tpu/ops/flash_attention.py`` (forward only).
The Pallas TPU kernels become hand-written CUDA kernels in
``csrc/flash_attention.cu``; each sits beside its plain PyTorch version:

- :func:`flash_fwd` (K1) replaces ``_flash_fwd``/``_kernel``: online
  softmax in the log2 domain, fp32 state, p cast to v's dtype before PV,
  out in q's dtype plus the natural-log lse. Plain version
  :func:`flash_fwd_plain` repeats that arithmetic densely.
- :func:`frame_ctx_fwd` (K2) replaces ``frame_ctx_kernel``: each frame's
  rows attend one softmax over [shared context ‖ own frame]. Plain version
  :func:`_frame_ctx_dense`.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises. Both kernels are bound by the
bf16 tensor-core rate at the main-path sizes (see the source notes in the
``.cu`` file) and take bf16, contiguous, d = 64 inputs.
"""

from __future__ import annotations

import torch

from .. import _kernels

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


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Dense twin of the K1 kernel. q: (BH, Nq, d); k/v: (BH, Nk, d).

    Same arithmetic as the kernel, in one tile: fp32 logits scaled into the
    log2 domain, p = exp2(s - m) cast to v's dtype before PV with fp32
    accumulation, out = acc / l (l == 0 guarded) in q's dtype, and the
    natural-log lse = m / log2(e) + log(l).
    """
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5 * LOG2E)
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


def flash_attention_lse(q, k, v, mask=None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> ((B, H, Nq, d), (B, H, Nq) fp32 lse)."""
    if mask is not None:
        raise NotImplementedError(
            "the RelocMask variant of the flash kernel is not ported yet"
        )
    B, H, Nq, d = q.shape
    Nk = k.shape[2]
    out, lse = flash_fwd(
        q.reshape(B * H, Nq, d).contiguous(),
        k.reshape(B * H, Nk, d).contiguous(),
        v.reshape(B * H, Nk, d).contiguous(),
    )
    return out.reshape(B, H, Nq, d), lse.reshape(B, H, Nq)


def flash_attention(q, k, v, mask=None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> (B, H, Nq, d)."""
    return flash_attention_lse(q, k, v, mask)[0]


def supported(q, k, v, mask) -> bool:
    return mask is None and q.shape[-1] <= 256 and q.dim() == 4


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
