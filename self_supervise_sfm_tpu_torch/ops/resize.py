"""Align-corners bilinear upsample (K3): the DPT heads' final upsample and
the fine tracker's patch-feature upsample.

Port of ``self_supervise_sfm_tpu/ops/resize.py``. The TPU version runs two
Pallas kernels (a W pass as a per-row interp matmul, then a 2-tap H lerp
with a fused addend and output cast); on the card one CUDA kernel
(``csrc/resize.cu``) does both in one pass as a 4-tap gather, reading the
input and the addend once and writing the output once (a thread owns a
pixel's channels in one chunk of the images; :func:`image_chunk` picks the
chunk so that the grid fills the card). Its sums differ from the
interp-matrix matmul only by fp32 rounding. The kernel is bound by memory
bytes.

:func:`resize_bilinear_fwd` is the launch wrapper: the plain version
:func:`resize_bilinear_plain` for a CPU tensor, the kernel for a CUDA
tensor; forward only, so under grad mode it raises on an input that requires
grad. :func:`resize_bilinear` is the differentiable entry, a
``torch.autograd.Function`` whose backward is autograd through the plain
resize, as the JAX ``custom_vjp`` (``heads/dpt_utils.py:54-80``) has it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import _kernels


def resize_kernel_applicable(shape, out_hw, min_elems: int = 1 << 27) -> bool:
    """Gate: an upsample the kernel takes, with at least ``min_elems`` output
    elements — by default the JAX gate's size (``ops/resize.py:147-164``,
    without its TPU VMEM terms): only the final DPT upsample beats the
    einsum path."""
    N, H, W, C = shape
    H2, W2 = out_hw
    if H2 < H or W2 < W or H < 2 or W < 2 or C % 4:
        return False
    return N * H2 * W2 * C >= min_elems


# the kernel's block (csrc/resize.cu THREADS) and the grid it aims for: a few
# waves of an H100's 132 SMs at 8 resident blocks of 256 threads each
THREADS = 256
TARGET_BLOCKS = 4 * 8 * 132
_MAX_GRID_Y = 65535


def image_chunk(n_img: int, H2: int, W2: int, C: int) -> int:
    """Images a block of K3 walks. Every image (one pass over the pixel grid)
    where the pixel grid alone fills the card, as at the DPT site; else the
    images cut into enough chunks that the grid reaches ``TARGET_BLOCKS``
    (at the fine tracker's (5120, 16, 16, 32) -> 31 x 31: 16 pixel blocks,
    256 chunks of 20 images)."""
    if n_img <= 0:
        return 1
    groups = C // (8 if C % 8 == 0 else 4)
    pixel_blocks = -(-H2 * W2 * groups // THREADS)
    n_chunks = min(n_img, max(1, -(-TARGET_BLOCKS // pixel_blocks)))
    return max(-(-n_img // n_chunks), -(-n_img // _MAX_GRID_Y))


def _taps(n: int, n2: int, device):
    """lo = min(floor(j (n-1) / (n2-1)), n-2) and the fp32 fraction.

    Computed with numpy: an IEEE fp32 division as in the kernel (PyTorch's
    CUDA division by a scalar multiplies by its reciprocal, which moves
    ``frac`` by an ulp of the source coordinate).
    """
    jn = np.arange(n2, dtype=np.int64) * (n - 1)
    lo = np.minimum(jn // (n2 - 1), n - 2)
    frac = jn.astype(np.float32) / np.float32(n2 - 1) - lo.astype(np.float32)
    return torch.from_numpy(lo).to(device), torch.from_numpy(frac).to(device)


def resize_bilinear_plain(x, out_hw, add=None, out_dtype=None):
    """Plain twin of the kernel: (N, H, W, C) -> (N, H2, W2, C), fp32 math."""
    N, H, W, C = x.shape
    H2, W2 = out_hw
    lh, fh = _taps(H, H2, x.device)
    lw, fw = _taps(W, W2, x.device)
    x32 = x.float()
    fw = fw[:, None]
    xw = x32[:, :, lw] * (1.0 - fw) + x32[:, :, lw + 1] * fw  # (N, H, W2, C)
    fh = fh[:, None, None]
    y = xw[:, lh] * (1.0 - fh) + xw[:, lh + 1] * fh
    if add is not None:
        y = y + add.float()
    return y.to(out_dtype or x.dtype)


def resize_bilinear_fwd(
    x: torch.Tensor, out_hw, add: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None, img_chunk: Optional[int] = None,
) -> torch.Tensor:
    """K3 wrapper. x: (N, H, W, C) fp32; add: optional (H2, W2, C) fp32.
    ``img_chunk``: images a block walks (default :func:`image_chunk`)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, add)):
        raise NotImplementedError(
            "resize_bilinear_fwd: forward only; call resize_bilinear instead")
    if x.device.type == "cpu":
        return resize_bilinear_plain(x, out_hw, add, out_dtype)
    N, H, W, C = x.shape
    H2, W2 = (int(s) for s in out_hw)
    out_dtype = out_dtype or x.dtype
    ts = (x,) if add is None else (x, add)
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("resize_bilinear: inputs must be contiguous, "
                             "16-byte aligned float32")
        if t.device != x.device:
            raise ValueError("resize_bilinear: tensors on different devices")
    if add is not None and tuple(add.shape) != (H2, W2, C):
        raise ValueError(f"resize_bilinear: addend shape {tuple(add.shape)}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"resize_bilinear: out dtype {out_dtype}")
    if C % 4 or H < 2 or W < 2 or H2 < H or W2 < W:
        raise ValueError(
            f"resize_bilinear: kernel takes C % 4 == 0 upsamples, got "
            f"{tuple(x.shape)} -> {(H2, W2)}"
        )
    chunk = image_chunk(N, H2, W2, C) if img_chunk is None else int(img_chunk)
    if chunk < 1 or -(-N // chunk) > _MAX_GRID_Y:
        raise ValueError(f"resize_bilinear: image chunk {chunk} for {N} images")
    out = torch.empty((N, H2, W2, C), dtype=out_dtype, device=x.device)
    if out.numel():
        _kernels.launch(
            "sfm_resize_bilinear_ac", x.data_ptr(),
            None if add is None else add.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), N, chunk, H, W, C, H2, W2,
            _kernels.stream_ptr(x),
        )
        resize_bilinear_fwd.launches += 1
    return out


resize_bilinear_fwd.launches = 0


class _ResizeBilinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, add, out_hw, out_dtype):
        ctx.save_for_backward(x, add)
        ctx.static = (out_hw, out_dtype)
        return resize_bilinear_fwd(x, out_hw, add, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, add = ctx.saved_tensors
        out_hw, out_dtype = ctx.static
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(need)
                   for t, need in zip((x, add), ctx.needs_input_grad)]
            y = resize_bilinear_plain(ins[0], out_hw, ins[1], out_dtype)
            want = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(y, want, g))
        return tuple(next(got) if t is not None and t.requires_grad else None
                     for t in ins) + (None, None)


def resize_bilinear(
    x: torch.Tensor, out_hw, add: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Differentiable K3: :func:`resize_bilinear_fwd` forward, autograd
    through :func:`resize_bilinear_plain` backward."""
    return _ResizeBilinear.apply(x, add, tuple(int(s) for s in out_hw), out_dtype)
