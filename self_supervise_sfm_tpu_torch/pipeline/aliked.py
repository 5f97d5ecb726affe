"""ALIKED-class deformable keypoint detector + descriptor.

Port of ``self_supervise_sfm_tpu/pipeline/aliked.py`` (the architecture of
"ALIKED: A Lighter Keypoint and Descriptor Extraction Network via
Deformable Transformation", Zhao et al., IEEE TIM 2023), NHWC activations
and PyTorch's OIHW conv weights:

- a 4-block encoder (full resolution, /2, /8, /32) whose two deep blocks
  use deformable 3 x 3 convolutions: an offset conv, then four-tap bilinear
  gathers with zero padding outside the map, one gather a kernel tap;
- the four branches projected to ``dim // 4`` channels each, upsampled to
  full resolution (half-pixel bilinear, ``align_corners=False``, as
  ``jax.image.resize``'s "bilinear" on an upsample) and concatenated; a
  sigmoid score-map head;
- detection: iterated max-pool NMS, a border mask, a fixed-size top-k (ties
  to the lower pixel index, as ``jax.lax.top_k``) and a 5 x 5 soft-argmax
  refinement on the raw score map;
- the sparse deformable descriptor head (SDDH): per keypoint, M sample
  offsets regressed from its K x K patch, the feature map sampled there and
  the samples aggregated by per-position projections into an L2-normalised
  descriptor; the JAX package's ``vmap`` over keypoints is one batched
  gather here.

:func:`aliked_keypoints` returns padded (max_pts, ...) tensors like the
other extractors of the zoo (``pipeline/extractors.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch
import torch.nn.functional as F

from ..layers import params as P
from ..models.sailrecon import _device


@dataclass(frozen=True)
class ALIKEDConfig:
    # aliked-n16 channel plan
    c1: int = 16
    c2: int = 32
    c3: int = 64
    c4: int = 128
    dim: int = 128  # aggregated feature dim (4 branches x dim // 4)
    desc_dim: int = 128
    kernel: int = 3  # SDDH patch size K
    num_samples: int = 16  # SDDH deformable positions M (the "n16")
    nms_radius: int = 2
    detection_threshold: float = 0.01
    border: int = 8


# -- params -------------------------------------------------------------------


def _conv_init(g, dev, cin, cout, k):
    w = torch.randn((cout, cin, k, k), generator=g, device=dev) * (2.0 / (k * k * cin)) ** 0.5
    return {"w": w, "b": torch.zeros((cout,), device=dev)}


def _dense_init(g, dev, cin, cout):
    w = torch.randn((cin, cout), generator=g, device=dev) * (2.0 / cin) ** 0.5
    return {"w": w, "b": torch.zeros((cout,), device=dev)}


def init_aliked(g: torch.Generator, cfg: ALIKEDConfig = ALIKEDConfig(), device="cuda") -> Dict:
    """Random params (He-normal, zero biases) from ``g``; the offset
    predictors start at zero, so each deformable conv starts as a plain
    conv and SDDH samples at the keypoint itself."""
    dev = _device(device)
    c1, c2, c3, c4, dim = cfg.c1, cfg.c2, cfg.c3, cfg.c4, cfg.dim
    K, M = cfg.kernel, cfg.num_samples
    convs = (
        ("b1_conv1", 3, c1, 3), ("b1_conv2", c1, c1, 3),
        ("b2_conv1", c1, c2, 3), ("b2_conv2", c2, c2, 3), ("b2_skip", c1, c2, 1),
        ("b3_off1", c2, 18, 3), ("b3_conv1", c2, c3, 3), ("b3_off2", c3, 18, 3),
        ("b3_conv2", c3, c3, 3), ("b3_skip", c2, c3, 1),
        ("b4_off1", c3, 18, 3), ("b4_conv1", c3, c4, 3), ("b4_off2", c4, 18, 3),
        ("b4_conv2", c4, c4, 3), ("b4_skip", c3, c4, 1),
        ("agg1", c1, dim // 4, 1), ("agg2", c2, dim // 4, 1), ("agg3", c3, dim // 4, 1),
        ("agg4", c4, dim // 4, 1),
        ("smh1", dim, 8, 1), ("smh2", 8, 4, 3), ("smh3", 4, 4, 3), ("smh4", 4, 1, 3),
    )
    p = {name: _conv_init(g, dev, cin, cout, k) for name, cin, cout, k in convs}
    p["sddh_off"] = _dense_init(g, dev, K * K * dim, 2 * M)
    p["sddh_proj"] = {"w": torch.randn((M, dim, cfg.desc_dim), generator=g, device=dev)
                      * (2.0 / dim) ** 0.5}
    p["sddh_out"] = _dense_init(g, dev, cfg.desc_dim, cfg.desc_dim)
    for n in ("b3_off1", "b3_off2", "b4_off1", "b4_off2", "sddh_off"):
        p[n]["w"] = torch.zeros_like(p[n]["w"])
    return p


# -- deformable convolution -----------------------------------------------------


def _bilinear_hw(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C) sampled at continuous y / x of shape (B, ...) ->
    (B, ..., C); taps outside the image read zero (torchvision's
    ``deform_conv2d`` convention)."""
    B, H, W, C = img.shape
    y0f, x0f = torch.floor(y), torch.floor(x)
    y0, x0 = y0f.long(), x0f.long()
    wy, wx = (y - y0f)[..., None], (x - x0f)[..., None]
    flat = img.reshape(B * H * W, C)
    base = (torch.arange(B, device=img.device) * (H * W)).reshape((B,) + (1,) * (y.dim() - 1))
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = flat[base + yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)]
        return torch.where(inside[..., None], v, zero)

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x0 + 1) * (1 - wy) * wx
            + tap(y0 + 1, x0) * wy * (1 - wx) + tap(y0 + 1, x0 + 1) * wy * wx)


def deform_conv(x: torch.Tensor, offsets: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """DCNv1 3 x 3 deformable convolution. x (B, H, W, Cin); offsets
    (B, H, W, 18), nine (dy, dx) pairs in row-major kernel-tap order
    (torchvision's layout); w (Cout, Cin, 3, 3). Each output pixel sums the
    taps sampled at ``p0 + p_k + offset_k``."""
    B, H, W, _ = x.shape
    yy, xx = torch.meshgrid(torch.arange(H, device=x.device), torch.arange(W, device=x.device),
                            indexing="ij")
    off = offsets.reshape(B, H, W, 9, 2)
    acc = torch.zeros((B, H, W, w.shape[0]), dtype=x.dtype, device=x.device)
    k = 0
    for ky in (-1, 0, 1):
        for kx in (-1, 0, 1):
            v = _bilinear_hw(x, yy + ky + off[..., k, 0], xx + kx + off[..., k, 1])
            acc = acc + v @ w[:, :, ky + 1, kx + 1].T.to(x.dtype)
            k += 1
    return acc + b.to(x.dtype)


# -- forward --------------------------------------------------------------------


def _gate(x):
    return F.selu(x)


def _avg_pool(x, k):
    """k x k mean pool, stride k, "VALID" (trailing rows / columns dropped)."""
    B, H, W, C = x.shape
    x = x[:, :H - H % k, :W - W % k]
    return x.reshape(B, H // k, k, W // k, k, C).sum(dim=(2, 4)) / float(k * k)


def _resize_bilinear(x, H, W):
    """Half-pixel bilinear upsample (NHWC), ``jax.image.resize``'s
    "bilinear" on an upsample."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(H, W), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def _res_block(p, x, name, deform: bool):
    if deform:
        o1 = P.conv2d(p[f"{name}_off1"], x)
        c1 = p[f"{name}_conv1"]
        h = _gate(deform_conv(x, o1, c1["w"], c1["b"]))
        o2 = P.conv2d(p[f"{name}_off2"], h)
        c2 = p[f"{name}_conv2"]
        h = deform_conv(h, o2, c2["w"], c2["b"])
    else:
        h = _gate(P.conv2d(p[f"{name}_conv1"], x))
        h = P.conv2d(p[f"{name}_conv2"], h)
    return _gate(h + P.conv2d(p[f"{name}_skip"], x))


def aliked_dense(p, images: torch.Tensor, cfg: ALIKEDConfig = ALIKEDConfig()):
    """images (B, H, W, 3) in [0, 1] -> (scores (B, H, W), features
    (B, H, W, dim), L2-normalised). H and W are multiples of 32."""
    B, H, W, _ = images.shape
    x1 = _gate(P.conv2d(p["b1_conv2"], _gate(P.conv2d(p["b1_conv1"], images))))
    x2 = _res_block(p, _avg_pool(x1, 2), "b2", deform=False)  # /2
    x3 = _res_block(p, _avg_pool(x2, 4), "b3", deform=True)  # /8
    x4 = _res_block(p, _avg_pool(x3, 4), "b4", deform=True)  # /32
    f = torch.cat([
        _gate(P.conv2d(p["agg1"], x1)),
        _resize_bilinear(_gate(P.conv2d(p["agg2"], x2)), H, W),
        _resize_bilinear(_gate(P.conv2d(p["agg3"], x3)), H, W),
        _resize_bilinear(_gate(P.conv2d(p["agg4"], x4)), H, W),
    ], dim=-1)
    s = _gate(P.conv2d(p["smh1"], f))
    s = _gate(P.conv2d(p["smh2"], s))
    s = _gate(P.conv2d(p["smh3"], s))
    scores = torch.sigmoid(P.conv2d(p["smh4"], s))[..., 0]
    feats = f / (torch.linalg.vector_norm(f, dim=-1, keepdim=True) + 1e-8)
    return scores, feats


def sddh_descriptors(p, feats: torch.Tensor, xy: torch.Tensor,
                     cfg: ALIKEDConfig = ALIKEDConfig()) -> torch.Tensor:
    """feats (H, W, dim) L2-normalised; xy (N, 2) keypoints in pixels ->
    (N, desc_dim) L2-normalised descriptors, every keypoint at once."""
    K, M = cfg.kernel, cfg.num_samples
    r = K // 2
    t = torch.arange(-r, r + 1, device=xy.device)
    dy, dx = (a.reshape(-1) for a in torch.meshgrid(t, t, indexing="ij"))  # (K K,)
    N = xy.shape[0]
    px, py = xy[:, 0:1], xy[:, 1:2]
    patch = _bilinear_hw(feats[None], (py + dy)[None], (px + dx)[None])[0]  # (N, K K, dim)
    off = patch.reshape(N, -1) @ p["sddh_off"]["w"] + p["sddh_off"]["b"]
    off = off.reshape(N, M, 2)  # (dy, dx)
    samples = _bilinear_hw(feats[None], (py + off[..., 0])[None],
                           (px + off[..., 1])[None])[0]  # (N, M, dim)
    d = torch.einsum("nmd,mde->ne", samples, p["sddh_proj"]["w"])
    d = _gate(d) @ p["sddh_out"]["w"] + p["sddh_out"]["b"]
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)


def _softargmax_refine(scores: torch.Tensor, xy: torch.Tensor, radius: int = 2):
    """Sub-pixel refinement: the soft-argmax (temperature 0.1) of the raw
    score map over the (2r+1)^2 neighbourhood of each peak."""
    H, W = scores.shape
    t = torch.arange(-radius, radius + 1, device=xy.device)
    dy, dx = (a.reshape(-1) for a in torch.meshgrid(t, t, indexing="ij"))
    y, x = xy[:, 1:2].long(), xy[:, 0:1].long()
    yy = (y + dy).clamp(0, H - 1)
    xx = (x + dx).clamp(0, W - 1)
    w = torch.softmax(scores[yy, xx] * 10.0, dim=-1)  # (N, (2r+1)^2)
    dxf, dyf = dx.to(scores.dtype), dy.to(scores.dtype)
    return xy + torch.stack([(w * dxf).sum(-1), (w * dyf).sum(-1)], dim=-1)


@torch.no_grad()
def aliked_keypoints(p, image: torch.Tensor, max_pts: int = 2048,
                     cfg: ALIKEDConfig = ALIKEDConfig()):
    """image (H, W, 3) in [0, 1] -> (xy (max_pts, 2), score (max_pts,),
    descriptors (max_pts, desc_dim)); entries past the detections have score
    0. The image is zero-padded to multiples of 32 for the /32 branch."""
    from .extractors import _top_k, simple_nms

    H, W, _ = image.shape
    Hp, Wp = -(-H // 32) * 32, -(-W // 32) * 32
    img = F.pad(image, (0, 0, 0, Wp - W, 0, Hp - H))
    scores, feats = aliked_dense(p, img[None], cfg)
    scores, feats = scores[0], feats[0]
    nmsed = simple_nms(scores[None], cfg.nms_radius)[0]
    b = cfg.border
    mask = torch.zeros((Hp, Wp), dtype=torch.bool, device=image.device)
    mask[b:H - b, b:W - b] = True
    nmsed = torch.where(mask & (nmsed > cfg.detection_threshold), nmsed,
                        torch.zeros_like(nmsed))
    vals, idx = _top_k(nmsed.reshape(-1), max_pts)
    xy = torch.stack([idx % Wp, idx // Wp], dim=-1).float()
    xy = _softargmax_refine(scores, xy)
    return xy, vals, sddh_descriptors(p, feats, xy, cfg)
