"""Flash attention (K1, K1m, B9) and fused [context ‖ own frame] attention (K2, K2p).

Port of ``self_supervise_sfm_tpu/ops/flash_attention.py``. The Pallas TPU
kernels become hand-written CUDA kernels: in bf16, K1, K1m, K2 and K2p share
one body written for Hopper in ``csrc/flash_fwd_sm90.cu`` (TMA ring, wgmma,
warp specialisation), the B9 pair, unmasked and under a RelocMask, another
in ``csrc/flash_bwd_sm90.cu``; in fp32, the forward forms share an FFMA body
in ``csrc/flash_fwd_f32.cu`` and the B9 pair another in
``csrc/flash_bwd_f32.cu``. Each sits beside its plain PyTorch version:

- :func:`flash_fwd` (K1) replaces ``_flash_fwd``/``_kernel``: online
  softmax in the log2 domain, fp32 state, p cast to v's dtype before PV,
  out in q's dtype plus the natural-log lse. Plain version
  :func:`flash_fwd_plain` repeats that arithmetic densely.
- :func:`flash_fwd_reloc` (K1m) is the same call under a
  :class:`~.mask_spec.RelocMask`: K2's walk, one frame's q rows against the
  context's key tiles, then the frame's own, with the mask expressed by
  the tensor maps' segments rather than evaluated per element. Plain
  version :func:`flash_fwd_plain` with the mask.
- :func:`frame_ctx_fwd` (K2) replaces ``frame_ctx_kernel``: each frame's
  rows attend one softmax over [shared context ‖ own frame]. Plain version
  :func:`_frame_ctx_dense`.
- :func:`frame_ctx_packed_fwd` (K2p) replaces ``frame_ctx_packed_kernel``:
  K2 with the context read in place from layer ``layer`` of the
  depth-stacked kv2 scene cache (depth, B, H, Nc, 2d), rows of [k ‖ v]. The
  wrapper hands the kernel the whole cache's pointer and the layer index
  and copies nothing of the cache. Plain version
  :func:`frame_ctx_packed_plain`.
- :func:`flash_bwd` (B9) replaces ``_flash_bwd``: ``delta = rowsum(do * o)
  - dlse`` in PyTorch, then :func:`flash_bwd_dq` (``_dq_kernel``: a block
  owns q rows and loops over key tiles) and :func:`flash_bwd_dkv`
  (``_dkv_kernel``: a block owns key rows and loops over q tiles), each
  recomputing p from the saved lse. Under a RelocMask the same kernels
  take work tiles that start and end at the mask's segments (context,
  frames) in place of a per-element mask. Plain version
  :func:`flash_bwd_plain`.

A wrapper takes its plain version only for a tensor on the CPU. For a CUDA
tensor it launches the kernel or raises. Every kernel takes contiguous
inputs of one dtype, in the forms :data:`FORWARD_FORMS` and
:data:`BACKWARD_FORMS` list: at head dim 64 or 128, bf16 (the Hopper
bodies, bound by the bf16 tensor-core rate) or fp32 (the FFMA bodies, bound
by the fp32 rate), forward and backward. Each wrapper counts its launches
by form: bf16 at 64 in ``.launches``, fp32 at 64 in ``.launches_f32``,
bf16 at 128 in ``.launches_d128``, fp32 at 128 in ``.launches_d128_f32``.
The "auto" gates ask :func:`kernel_takes` and send a site the kernels do
not take (a head dim without a kernel, operands of two dtypes) to the
dense path.

Autograd reaches the kernels only through the ``torch.autograd.Function``s
behind :func:`flash_attention`, :func:`flash_attention_lse` and
:func:`frame_ctx_attention` (the JAX package's ``custom_vjp``s). The bare
forward wrappers return tensors with no ``grad_fn``, so under grad mode they
raise on an input that requires grad, on every device, rather than cut the
graph.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from .mask_spec import RelocMask

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# what every attention kernel takes: its Hopper form or its FFMA form
_DTYPES = (torch.bfloat16, torch.float32)
# head dim -> the dtypes with a kernel: the forward forms (K1, K1m, K2, K2p)
# and the backward (B9's dq and dk/dv)
FORWARD_FORMS = {64: _DTYPES, 128: _DTYPES}
BACKWARD_FORMS = {64: _DTYPES, 128: _DTYPES}


def _check_form(name: str, d: int, dtype: torch.dtype, forms=FORWARD_FORMS) -> None:
    """Raise unless ``forms`` has a kernel of head dim ``d`` in ``dtype``."""
    dims = [h for h, dts in forms.items() if dtype in dts]
    if d not in dims:
        what = "kernels" if forms is FORWARD_FORMS else "backward kernels"
        raise ValueError(f"{name}: the {str(dtype).removeprefix('torch.')} {what} take head "
                         f"dim {' or '.join(map(str, dims))}, got {d}")


def _check_cuda(name: str, *ts: torch.Tensor, forms=FORWARD_FORMS) -> None:
    """Device, dtype (bf16 or fp32, the same for every operand), layout,
    head dim (a form of ``forms``) and alignment of a kernel's operands."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got {t.dtype}")
        if t.dtype != ts[0].dtype:
            raise TypeError(f"{name}: operands of one dtype, got {ts[0].dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.shape[-1] != ts[0].shape[-1]:
            raise ValueError(f"{name}: operands of one head dim, got {ts[0].shape[-1]} "
                             f"and {t.shape[-1]}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    _check_form(name, ts[0].shape[-1], ts[0].dtype, forms)


def _grad(*ts: torch.Tensor) -> bool:
    """Whether autograd differentiates a call on ``ts``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _check_backward(name: str, *ts: torch.Tensor) -> None:
    """A differentiable entry that autograd differentiates off the CPU needs
    the backward kernels of its head dim and dtype: raise before the forward
    when they do not exist (a head dim other than 64 or 128), rather than
    after it."""
    if ts[0].device.type != "cpu" and _grad(*ts):
        _check_form(name, ts[0].shape[-1], ts[0].dtype, BACKWARD_FORMS)


def _check_no_grad(name: str, *ts: torch.Tensor) -> None:
    """A bare launch returns tensors with no ``grad_fn``: refuse to cut the
    autograd graph silently (differentiable callers go through the
    Functions, whose ``forward`` runs with grad mode off)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            f"{name}: a bare kernel launch is not differentiable; call the "
            "differentiable entry (flash_attention, flash_attention_lse, "
            "frame_ctx_attention) instead")


def _count(fn, dtype: torch.dtype, head_dim: int = 64) -> None:
    """One launch of ``fn``'s kernel, counted by form: at head dim 64 bf16
    in ``fn.launches`` and fp32 in ``fn.launches_f32``; at 128 bf16 in
    ``fn.launches_d128`` and fp32 in ``fn.launches_d128_f32``."""
    bf16 = dtype == torch.bfloat16
    if head_dim == 128:
        if bf16:
            fn.launches_d128 += 1
        else:
            fn.launches_d128_f32 += 1
    elif bf16:
        fn.launches += 1
    else:
        fn.launches_f32 += 1


def _hd(head_dim: int) -> str:
    """The head-dim part of an entry's name: none at 64, "d128_" at 128."""
    return "d128_" if head_dim == 128 else ""


def _suffix(dtype: torch.dtype, head_dim: int = 64) -> str:
    return _hd(head_dim) + ("bf16" if dtype == torch.bfloat16 else "f32")


def _body(dtype: torch.dtype, head_dim: int = 64) -> str:
    """The suffix of K1m's and B9's entries: the Hopper body's (bf16) or the
    FFMA body's (fp32), after the head dim's part."""
    return _hd(head_dim) + ("sm90" if dtype == torch.bfloat16 else "f32")


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
    _check_no_grad("flash_fwd", q, k, v)
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
            f"sfm_flash_fwd_{_suffix(q.dtype, d)}", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, Nq, Nk, d**-0.5 * LOG2E,
            _kernels.stream_ptr(q),
        )
        _count(flash_fwd, q.dtype, d)
    return out, lse


flash_fwd.launches = flash_fwd.launches_f32 = flash_fwd.launches_d128 = 0
flash_fwd.launches_d128_f32 = 0


def _check_mask(name: str, mask: RelocMask, nq: int, nk: int) -> None:
    if mask.frame_size <= 0 or mask.n_ctx < 0 or mask.nq != nq or mask.nk != nk:
        raise ValueError(f"{name}: {mask} does not describe ({nq}, {nk}) logits")


def flash_fwd_reloc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: RelocMask):
    """K1m wrapper: :func:`flash_fwd` under a RelocMask. q: (BH, F*P, d);
    k/v: (BH, n_ctx + F*P, d), keys laid out [context ‖ frames]; bf16 on
    the Hopper body, fp32 on the FFMA body (d = 64 or 128)."""
    _check_no_grad("flash_fwd_reloc", q, k, v)
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
            f"sfm_flash_fwd_reloc_{_body(q.dtype, d)}", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, Nq, Nk, mask.n_ctx,
            mask.frame_size, mask.num_frames, d**-0.5 * LOG2E,
            _kernels.stream_ptr(q),
        )
        _count(flash_fwd_reloc, q.dtype, d)
    return out, lse


flash_fwd_reloc.launches = flash_fwd_reloc.launches_f32 = flash_fwd_reloc.launches_d128 = 0
flash_fwd_reloc.launches_d128_f32 = 0


# -- B9: flash backward (dq kernel, dk/dv kernel) -----------------------------


def _delta(o, do, dlse=None):
    """rowsum(do * o) in fp32, shifted by the lse cotangent: d lse_i / d s_ij
    = p_ij, so ds = p * (do v^T - (delta - dlse)) (``_flash_bwd``)."""
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def flash_bwd_plain(q, k, v, o, lse, do, dlse=None,
                    mask: Optional[RelocMask] = None):
    """Dense twin of the B9 kernels: (dq, dk, dv) of (BH, N, d) attention.

    Same arithmetic as ``_dq_kernel`` / ``_dkv_kernel``: fp32 logits scaled
    into the log2 domain, p = exp2(s - lse * log2(e)) from the saved
    natural-log lse (0 where masked), ds = p * (do v^T - delta) * scale, and
    ds and p cast to the input dtype before their products, which
    accumulate in fp32.
    """
    d = q.shape[-1]
    scale = d**-0.5
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale * LOG2E)
    p = torch.exp2(s - (lse.float() * LOG2E)[..., None])
    if mask is not None:
        _check_mask("flash_bwd_plain", mask, q.shape[1], k.shape[1])
        p = torch.where(mask.materialize(q.device)[0], p, torch.zeros_like(p))
    dov = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dov - _delta(o, do, dlse)[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()).to(q.dtype)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), q.float()).to(k.dtype)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float()).to(v.dtype)
    return dq, dk, dv


def _check_bwd(name, q, k, v, do, lse, delta, mask) -> None:
    """What the B9 kernels take: q / k / v / do of one dtype and head dim on
    one device, a form of :data:`BACKWARD_FORMS` (64 or 128, bf16 or fp32),
    fp32 contiguous (BH, Nq) lse and delta, shapes that agree."""
    _check_cuda(name, q, k, v, do, forms=BACKWARD_FORMS)
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if k.shape != (BH, Nk, d) or v.shape != k.shape or do.shape != q.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do {tuple(do.shape)}")
    for key, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != q.device
                or tuple(t.shape) != (BH, Nq)):
            raise TypeError(f"{name}: {key} must be contiguous float32 ({BH}, {Nq}) "
                            f"on {q.device}")
    if mask is not None:
        _check_mask(name, mask, Nq, Nk)


def _bwd_entry(name: str, dtype: torch.dtype, head_dim: int, mask: Optional[RelocMask]):
    """The C entry of a B9 kernel and its trailing shape arguments: the
    unmasked form of ``dtype``'s body at ``head_dim``, or its RelocMask form
    with the mask's context and frame size."""
    body = _body(dtype, head_dim)
    if mask is None:
        return f"sfm_flash_bwd_{name}_{body}", ()
    return f"sfm_flash_bwd_{name}_reloc_{body}", (mask.n_ctx, mask.frame_size)


def flash_bwd_dq(q, k, v, do, lse, delta, mask: Optional[RelocMask] = None):
    """The dq kernel (``_dq_kernel``): (BH, Nq, d) in q's dtype, for CUDA
    tensors. ``delta`` is :func:`flash_bwd`'s rowsum(do * o) - dlse. With no key the
    gradient is zero and nothing is launched."""
    _check_bwd("flash_bwd_dq", q, k, v, do, lse, delta, mask)
    BH, Nq, d = q.shape
    Nk = k.shape[1]
    if not Nk:
        return torch.zeros_like(q)
    dq = torch.empty_like(q)
    if BH and Nq:
        entry, extra = _bwd_entry("dq", q.dtype, d, mask)
        _kernels.launch(
            entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, Nq, Nk, *extra,
            d**-0.5 * LOG2E, d**-0.5, _kernels.stream_ptr(q),
        )
        _count(flash_bwd_dq, q.dtype, d)
    return dq


flash_bwd_dq.launches = flash_bwd_dq.launches_f32 = flash_bwd_dq.launches_d128 = 0
flash_bwd_dq.launches_d128_f32 = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, mask: Optional[RelocMask] = None):
    """The dk/dv kernel (``_dkv_kernel``): two (BH, Nk, d) tensors in k's
    dtype, for CUDA tensors. With no q row the gradients are zero and
    nothing is launched."""
    _check_bwd("flash_bwd_dkv", q, k, v, do, lse, delta, mask)
    BH, Nk, d = k.shape
    Nq = q.shape[1]
    if not Nq:
        return torch.zeros_like(k), torch.zeros_like(v)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if BH and Nk:
        entry, extra = _bwd_entry("dkv", q.dtype, d, mask)
        _kernels.launch(
            entry, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), BH, Nq,
            Nk, *extra, d**-0.5 * LOG2E, d**-0.5, _kernels.stream_ptr(q),
        )
        _count(flash_bwd_dkv, q.dtype, d)
    return dk, dv


flash_bwd_dkv.launches = flash_bwd_dkv.launches_f32 = flash_bwd_dkv.launches_d128 = 0
flash_bwd_dkv.launches_d128_f32 = 0


def flash_bwd(q, k, v, o, lse, do, dlse=None, mask: Optional[RelocMask] = None):
    """B9 wrapper: (dq, dk, dv) of :func:`flash_fwd` / :func:`flash_fwd_reloc`
    from its inputs, output, lse and the cotangents of out (and of lse).
    q/o/do: (BH, Nq, d); k/v: (BH, Nk, d); lse/dlse: (BH, Nq) fp32."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, dlse, mask)
    _check_cuda("flash_bwd", q, o, forms=BACKWARD_FORMS)
    if o.shape != q.shape:
        raise ValueError(f"flash_bwd: o {tuple(o.shape)} against q {tuple(q.shape)}")
    delta = _delta(o, do, dlse).contiguous()
    dq = flash_bwd_dq(q, k, v, do, lse, delta, mask)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, mask)
    return dq, dk, dv


def _flat(q, k, v, mask):
    """(B, H, N, d) -> contiguous (B*H, N, d) views of q, k, v."""
    if mask is not None and not isinstance(mask, RelocMask):
        raise TypeError(
            "the flash kernel takes a RelocMask or no mask; boolean masks "
            "stay on the dense path")
    return tuple(t.reshape(-1, *t.shape[2:]).contiguous() for t in (q, k, v))


def _attend(ctx, q, k, v, mask):
    """Shared forward of the two Functions: K1 / K1m on the flattened heads;
    saves what B9 needs."""
    B, H, Nq, d = q.shape
    qf, kf, vf = _flat(q, k, v, mask)
    out, lse = flash_fwd(qf, kf, vf) if mask is None else flash_fwd_reloc(qf, kf, vf, mask)
    ctx.save_for_backward(qf, kf, vf, out, lse)
    ctx.mask = mask
    ctx.shapes = (q.shape, k.shape)
    return out.reshape(B, H, Nq, d), lse.reshape(B, H, Nq)


def _attend_bwd(ctx, do, dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = torch.zeros_like(o) if do is None else do.reshape(o.shape).contiguous()
    if dlse is not None:
        dlse = dlse.reshape(lse.shape)
    dq, dk, dv = flash_bwd(q, k, v, o, lse, do, dlse, ctx.mask)
    qs, ks = ctx.shapes
    return dq.reshape(qs), dk.reshape(ks), dv.reshape(ks), None


class _FlashAttention(torch.autograd.Function):
    """``_flash_mha``: K1 / K1m forward, B9 backward. (B, H, N, d) inputs."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        return _attend(ctx, q, k, v, mask)[0]

    @staticmethod
    def backward(ctx, do):
        return _attend_bwd(ctx, do, None)


class _FlashAttentionLse(torch.autograd.Function):
    """``_flash_mha_lse``: out and lse, both differentiable; the lse
    cotangent goes into delta."""

    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.set_materialize_grads(False)
        return _attend(ctx, q, k, v, mask)

    @staticmethod
    def backward(ctx, do, dlse):
        return _attend_bwd(ctx, do, dlse)


def flash_attention_lse(q, k, v, mask: Optional[RelocMask] = None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> ((B, H, Nq, d), (B, H, Nq) fp32 lse).
    Differentiable in q, k, v through both outputs (off the CPU in the forms
    of :data:`BACKWARD_FORMS`: a differentiated call at another head dim
    raises)."""
    _check_backward("flash_attention_lse", q, k, v)
    return _FlashAttentionLse.apply(q, k, v, mask)


def flash_attention(q, k, v, mask: Optional[RelocMask] = None):
    """(B, H, Nq, d) x (B, H, Nk, d)^2 -> (B, H, Nq, d). Differentiable (off
    the CPU in the forms of :data:`BACKWARD_FORMS`: a differentiated call at
    another head dim raises)."""
    _check_backward("flash_attention", q, k, v)
    return _FlashAttention.apply(q, k, v, mask)


def supported(q, k, v, mask) -> bool:
    """Whether the flash route takes the call at all (``impl="flash"``
    asks for it; the kernel itself then raises on what it does not take)."""
    if mask is not None and not isinstance(mask, RelocMask):
        return False  # dense boolean masks stay on the dense path
    return q.shape[-1] <= 256 and q.dim() == 4


def kernel_takes(q, k, v, *ctx) -> bool:
    """The one check of the "auto" gates: whether the attention kernels take
    the site (``ctx``: the context tensors the site also attends to). A CPU
    tensor always qualifies, since its wrapper runs the dtype-generic plain
    version. On the card: q / k / v of one dtype at a head dim with a
    forward kernel in it (:data:`FORWARD_FORMS`: 64 or 128, bf16 or fp32)
    and, where autograd differentiates the site (q, k, v or the context), a
    backward kernel too (:data:`BACKWARD_FORMS`: the same forms). A mask does not change the route: every forward form (K1, K1m, K2, K2p)
    and B9 unmasked and under a RelocMask exist at the same head dims. An
    explicit ``impl="flash"`` skips this check and reaches the kernels' own
    refusals: a kernel that does not exist is not turned into dense."""
    if q.device.type == "cpu":
        return True
    d, dt = q.shape[-1], q.dtype
    if k.dtype != dt or v.dtype != dt or dt not in FORWARD_FORMS.get(d, ()):
        return False
    return not _grad(q, k, v, *ctx) or dt in BACKWARD_FORMS.get(d, ())


def worth_it(q, k, v) -> bool:
    """The "auto" gate: a site the kernels take, at or above the JAX
    package's measured cut-over (``ops/flash_attention.py:814-817``)."""
    return kernel_takes(q, k, v) and q.shape[-2] * k.shape[-2] >= 1_500_000


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
    _check_no_grad("frame_ctx_fwd", q, k, v, ck, cv)
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
            f"sfm_frame_ctx_fwd_{_suffix(q.dtype, d)}", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ck.data_ptr(), cv.data_ptr(), out.data_ptr(), BF, H, BF // B,
            P, Nc, d**-0.5 * LOG2E, _kernels.stream_ptr(q),
        )
        _count(frame_ctx_fwd, q.dtype, d)
    return out


frame_ctx_fwd.launches = frame_ctx_fwd.launches_f32 = frame_ctx_fwd.launches_d128 = 0
frame_ctx_fwd.launches_d128_f32 = 0


def _frame_ctx_split(q, k, v, ck, cv):
    """The differentiable composition that matches K2: own-frame flash and
    broadcast-context flash merged by lse (exact softmax). Its VJP runs the
    B9 kernels of both calls, the lse cotangent of the merge included."""
    from .ring_attention import _merge

    BF, B = q.shape[0], ck.shape[0]
    F = BF // B

    def bcast(c):
        return c[:, None].expand(B, F, *c.shape[1:]).reshape(BF, *c.shape[1:])

    o_own, lse_own = flash_attention_lse(q, k, v)
    o_ctx, lse_ctx = flash_attention_lse(q, bcast(ck).to(k.dtype), bcast(cv).to(v.dtype))
    out, _ = _merge(o_own.float(), lse_own, o_ctx.float(), lse_ctx)
    return out.to(q.dtype)


class _FrameCtxAttention(torch.autograd.Function):
    """``frame_ctx_attention``'s ``custom_vjp``: K2 forward; backward the
    VJP of :func:`_frame_ctx_split` (recomputed, as ``_frame_ctx_bwd``
    does). The context gradients sum over the frames of each scene."""

    @staticmethod
    def forward(ctx, q, k, v, ck, cv):
        ctx.save_for_backward(q, k, v, ck, cv)
        return frame_ctx_fwd(q, k, v, ck, cv)

    @staticmethod
    def backward(ctx, g):
        res = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = _frame_ctx_split(*res)
        return torch.autograd.grad(out, res, g)


def frame_ctx_attention(q, k, v, ck, cv):
    """Fused reloc attention: frame-major q/k/v against shared context K/V.
    Differentiable in all five (off the CPU in the forms of
    :data:`BACKWARD_FORMS`: the backward is two flash calls' B9; a
    differentiated call at another head dim raises)."""
    _check_backward("frame_ctx_attention", q, k, v, ck, cv)
    return _FrameCtxAttention.apply(
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
    _check_no_grad("frame_ctx_packed_fwd", q, k, v, ckv)
    if q.device.type == "cpu":
        return frame_ctx_packed_plain(q, k, v, ckv, layer)
    _check_packed(q, k, v, ckv, layer)
    _check_cuda("frame_ctx_packed_fwd", q, k, v)
    if ckv.device != q.device or ckv.dtype != q.dtype:
        raise TypeError(
            f"frame_ctx_packed_fwd: the cache must be {q.dtype} on {q.device}, "
            f"got {ckv.dtype} on {ckv.device}")
    if ckv.data_ptr() % 16:
        raise ValueError("frame_ctx_packed_fwd: the cache must be 16-byte aligned")
    BF, H, P, d = q.shape
    _, B, _, Nc, _ = ckv.shape
    out = torch.empty_like(q)
    if BF and P:
        _kernels.launch(
            f"sfm_frame_ctx_kv2_fwd_{_suffix(q.dtype, d)}", q.data_ptr(), k.data_ptr(),
            v.data_ptr(), ckv.data_ptr(), out.data_ptr(), BF, H, BF // B, P, Nc,
            layer, B * H * Nc * 2 * d, d**-0.5 * LOG2E, _kernels.stream_ptr(q),
        )
        _count(frame_ctx_packed_fwd, q.dtype, d)
    return out


frame_ctx_packed_fwd.launches = frame_ctx_packed_fwd.launches_f32 = 0
frame_ctx_packed_fwd.launches_d128 = frame_ctx_packed_fwd.launches_d128_f32 = 0


def packed_ctx_attention(q, k, v, ckv, layer: int, impl: str = "auto"):
    """[ctx ‖ own] reloc attention against one layer of the kv2 scene cache.

    The gate is the one of the frame-major context site in
    ``layers/attention.py``: the in-place kernel wrapper when ``impl`` is not
    "dense", the head dim is at most 256, and either ``impl == "flash"`` or
    the kernel takes the site (:func:`kernel_takes`, and a cache of q's dtype
    off the CPU) with ``P * (Nc + P) >= 1.5M`` (the JAX package's cut,
    without its TPU-backend condition; the wrapper itself takes its plain
    version for a CPU tensor only). Otherwise the layer is sliced and split
    and the dense reference runs: a cache of another dtype than q's on the
    card takes that route under "auto", and so does a call that autograd
    differentiates (K2p has no backward: the serving path, as in the JAX
    package)."""
    d = q.shape[-1]
    Nc = ckv.shape[3]
    grad = _grad(q, k, v, ckv)
    takes = (kernel_takes(q, k, v) and not grad
             and (ckv.device.type == "cpu" or ckv.dtype == q.dtype))
    if (
        impl != "dense"
        and d <= 256
        and (impl == "flash" or (takes and q.shape[2] * (Nc + k.shape[2]) >= 1_500_000))
    ):
        return frame_ctx_packed_fwd(
            q.contiguous(), k.contiguous(), v.contiguous(), ckv, layer)
    ck, cv = ckv[layer, ..., :d], ckv[layer, ..., d:]
    return _frame_ctx_dense(q, k, v, ck.to(k.dtype), cv.to(v.dtype))
