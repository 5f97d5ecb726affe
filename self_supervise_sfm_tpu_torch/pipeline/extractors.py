"""Keypoint extractors: SuperPoint, a DoG (SIFT detector stage) and the
Shi-Tomasi corners, and their union.

Port of ``self_supervise_sfm_tpu/pipeline/extractors.py``:

- ``superpoint_*``: the SuperPoint network (VGG encoder, 65-way cell
  detector with the dustbin dropped, 256-d descriptor head), iterated
  max-pool NMS and a fixed-size top-k;
- :func:`dog_keypoints`: Difference-of-Gaussians scale-space extrema with
  the contrast gate and the Hessian edge test;
- :func:`initialize_feature_extractors` / :func:`extract_keypoints_union`:
  the zoo and the de-duplicated union of its detections.

- ``"aliked"``: the ALIKED deformable detector and descriptor
  (``pipeline/aliked.py``), random weights from a seed as in the JAX zoo;
- :func:`convert_torch_superpoint`: the public SuperPoint weights (the
  magicleap / lightglue state dict) -> the tree ``superpoint_*`` takes.

The top-k keeps, among equal scores, the lower pixel index first, as
``jax.lax.top_k`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..layers import params as P
from ..models.sailrecon import _device


@dataclass(frozen=True)
class SuperPointConfig:
    descriptor_dim: int = 256
    nms_radius: int = 4
    detection_threshold: float = 0.0005
    remove_borders: int = 4


_ENC = (
    ("conv1a", 1, 64), ("conv1b", 64, 64),
    ("conv2a", 64, 64), ("conv2b", 64, 64),
    ("conv3a", 64, 128), ("conv3b", 128, 128),
    ("conv4a", 128, 128), ("conv4b", 128, 128),
)
_GRAY = (0.299, 0.587, 0.114)


def init_superpoint(generator: torch.Generator, cfg: SuperPointConfig = SuperPointConfig(),
                    device="cuda"):
    """Random SuperPoint params (He-normal convs, zero biases)."""
    dev = _device(device)
    p = {name: P.init_conv(generator, dev, 3, 3, cin, cout) for name, cin, cout in _ENC}
    p["convPa"] = P.init_conv(generator, dev, 3, 3, 128, 256)
    p["convPb"] = P.init_conv(generator, dev, 1, 1, 256, 65)
    p["convDa"] = P.init_conv(generator, dev, 3, 3, 128, 256)
    p["convDb"] = P.init_conv(generator, dev, 1, 1, 256, cfg.descriptor_dim)
    return p


def convert_torch_superpoint(state_dict) -> dict:
    """The public SuperPoint torch weights (``conv1a.weight`` (out, in, kh,
    kw), ...: numpy arrays or tensors) -> the port's tree, fp32 CPU tensors
    in PyTorch's own OIHW layout (the JAX converter permutes them to HWIO)."""
    def cv(name):
        return {k: torch.as_tensor(np.asarray(state_dict[f"{name}.{t}"], np.float32)).clone()
                for k, t in (("w", "weight"), ("b", "bias"))}

    names = [n for n, _, _ in _ENC] + ["convPa", "convPb", "convDa", "convDb"]
    return {n: cv(n) for n in names}


def _pool(x):  # (B, H, W, C) 2x2 max pool, VALID
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def superpoint_dense(p, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) grayscale in [0, 1] -> (scores (B, H, W), descriptors
    (B, H / 8, W / 8, D), L2-normalised)."""
    x = images[..., None]
    for i, (name, _, _) in enumerate(_ENC):
        x = torch.relu(P.conv2d(p[name], x))
        if i in (1, 3, 5):
            x = _pool(x)
    feat = x
    logits = P.conv2d(p["convPb"], torch.relu(P.conv2d(p["convPa"], feat)))
    probs = torch.softmax(logits, dim=-1)[..., :64]  # the dustbin dropped
    B, Hc, Wc, _ = probs.shape
    scores = probs.reshape(B, Hc, Wc, 8, 8).transpose(2, 3).reshape(B, Hc * 8, Wc * 8)
    desc = P.conv2d(p["convDb"], torch.relu(P.conv2d(p["convDa"], feat)))
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    return scores, desc


def _maxpool_same(x, k):  # (B, H, W), stride 1, -inf padding
    return F.max_pool2d(x[:, None], k, stride=1, padding=k // 2)[:, 0]


def simple_nms(scores: torch.Tensor, radius: int, iters: int = 2) -> torch.Tensor:
    """Iterated max-pool NMS: keep the pixels that are the local maximum."""
    k = 2 * radius + 1
    zeros = torch.zeros_like(scores)
    max_mask = scores == _maxpool_same(scores, k)
    for _ in range(iters):
        supp = _maxpool_same(torch.where(max_mask, scores, zeros), k) > scores
        supp_scores = torch.where(supp, zeros, scores)
        new_max = supp_scores == _maxpool_same(supp_scores, k)
        max_mask = max_mask | (new_max & ~supp)
    return torch.where(max_mask, scores, zeros)


def _top_k(flat: torch.Tensor, k: int):
    """Values and indices of the k largest, ties to the lower index (a
    stable descending sort), as ``jax.lax.top_k``."""
    vals, idx = torch.sort(flat, descending=True, stable=True)
    return vals[:k], idx[:k]


def _gray(image: torch.Tensor) -> torch.Tensor:
    if image.dim() == 3:
        return image @ torch.tensor(_GRAY, dtype=image.dtype, device=image.device)
    return image


def _border_mask(H, W, b, device):
    mask = torch.zeros((H, W), dtype=torch.bool, device=device)
    mask[b:-b, b:-b] = True
    return mask


@torch.no_grad()
def superpoint_keypoints(p, image: torch.Tensor, max_pts: int = 2048,
                         cfg: SuperPointConfig = SuperPointConfig()):
    """image (H, W) or (H, W, 3) in [0, 1] -> (xy (max_pts, 2), score
    (max_pts,), descriptors (max_pts, D)); entries past the detections have
    score 0."""
    image = _gray(image)
    H, W = image.shape
    # the encoder floors sides that are no multiple of 8: zero-pad up, crop
    # the score map back
    H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
    padded = F.pad(image, (0, W8 - W, 0, H8 - H)) if (H8, W8) != (H, W) else image
    scores, desc = superpoint_dense(p, padded[None])
    scores = simple_nms(scores, cfg.nms_radius)[0, :H, :W]
    keep = _border_mask(H, W, cfg.remove_borders, image.device) & (
        scores > cfg.detection_threshold)
    scores = torch.where(keep, scores, torch.zeros_like(scores))
    vals, idx = _top_k(scores.reshape(-1), max_pts)
    xy = torch.stack([idx % W, idx // W], dim=-1).float()
    # descriptors sampled bilinearly on the H/8 grid, align_corners=False
    gx = (xy[:, 0] + 0.5) / 8.0 - 0.5
    gy = (xy[:, 1] + 0.5) / 8.0 - 0.5
    d = _bilinear(desc[0], gx, gy)
    d = d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-8)
    return xy, vals, d


def _bilinear(grid: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """grid (H, W, C) at continuous x, y (N,) -> (N, C), clamped taps."""
    H, W, _ = grid.shape
    x0 = torch.clamp(torch.floor(x).long(), 0, W - 1)
    y0 = torch.clamp(torch.floor(y).long(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, 0, W - 1)
    y1 = torch.clamp(y0 + 1, 0, H - 1)
    wx = torch.clamp(x - x0, 0.0, 1.0)[:, None]
    wy = torch.clamp(y - y0, 0.0, 1.0)[:, None]
    return (grid[y0, x0] * (1 - wx) * (1 - wy) + grid[y0, x1] * wx * (1 - wy)
            + grid[y1, x0] * (1 - wx) * wy + grid[y1, x1] * wx * wy)


def _gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (H, W), zero padding."""
    r = max(int(3.0 * sigma + 0.5), 1)
    t = torch.arange(-r, r + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    x = F.conv2d(img[None, None], k.reshape(1, 1, -1, 1), padding=(r, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1), padding=(0, r))
    return x[0, 0]


@torch.no_grad()
def dog_keypoints(image: torch.Tensor, max_pts: int = 2048, num_scales: int = 3,
                  sigma0: float = 1.6, contrast_threshold: float = 0.015,
                  edge_ratio: float = 10.0, border: int = 8):
    """Difference-of-Gaussians extrema over (x, y, scale) in one octave:
    (xy (max_pts, 2), score (max_pts,)), zero scores past the detections."""
    image = _gray(image)
    H, W = image.shape
    k = 2.0 ** (1.0 / num_scales)
    gauss = torch.stack([_gaussian_blur(image, sigma0 * k**i)
                         for i in range(num_scales + 3)])
    dog = gauss[1:] - gauss[:-1]  # (num_scales + 2, H, W)
    absd = dog.abs()
    pooled = F.max_pool3d(absd[None, None], 3, stride=1, padding=1)[0, 0]
    is_ext = (absd >= pooled) & (absd > contrast_threshold)

    def roll(x, sy, sx):
        return torch.roll(torch.roll(x, sy, 1), sx, 2)

    dxx = torch.roll(dog, -1, 2) + torch.roll(dog, 1, 2) - 2 * dog
    dyy = torch.roll(dog, -1, 1) + torch.roll(dog, 1, 1) - 2 * dog
    dxy = (roll(dog, -1, -1) - roll(dog, -1, 1) - roll(dog, 1, -1) + roll(dog, 1, 1)) / 4.0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    score = torch.where(is_ext & edge_ok, absd, torch.zeros_like(absd))
    score = score[1:-1].amax(0)
    score = torch.where(_border_mask(H, W, border, image.device), score,
                        torch.zeros_like(score))
    vals, idx = _top_k(score.reshape(-1), max_pts)
    return torch.stack([idx % W, idx // W], dim=-1).float(), vals


def initialize_feature_extractors(methods: str = "shi_tomasi", max_pts: int = 2048,
                                  superpoint_params: Optional[dict] = None,
                                  device="cuda") -> Dict[str, callable]:
    """'+'-separated extractor spec -> {name: image -> (N, 2) xy numpy}.
    Supported: shi_tomasi (numpy, on the host), superpoint, dog and aliked
    (on ``device``)."""
    from .tracking import extract_keypoints as shi_tomasi

    zoo: Dict[str, callable] = {}
    for m in methods.split("+"):
        m = m.strip().lower()
        if m in ("shi_tomasi", "shitomasi"):
            zoo[m] = lambda img: shi_tomasi(np.asarray(img), max_pts=max_pts)
        elif m == "superpoint":
            dev = _device(device)
            p = superpoint_params
            if p is None:
                p = init_superpoint(torch.Generator(device=dev).manual_seed(0), device=dev)

            def sp(img, _p=p, _dev=dev):
                xy, s, _ = superpoint_keypoints(_p, torch.as_tensor(img).to(_dev), max_pts)
                return xy[s > 0].cpu().numpy()
            zoo[m] = sp
        elif m in ("dog", "sift"):
            dev = _device(device)

            def dg(img, _dev=dev):
                xy, s = dog_keypoints(torch.as_tensor(img).to(_dev), max_pts)
                return xy[s > 0].cpu().numpy()
            zoo[m] = dg
        elif m == "aliked":
            from . import aliked as A

            dev = _device(device)
            ap = A.init_aliked(torch.Generator(device=dev).manual_seed(0), device=dev)

            def ak(img, _p=ap, _dev=dev):
                img = torch.as_tensor(np.asarray(img, np.float32)).to(_dev)
                if img.dim() == 2:
                    img = img[..., None].expand(*img.shape, 3)
                xy, s, _ = A.aliked_keypoints(_p, img, max_pts)
                return xy[s > 0].cpu().numpy()
            zoo[m] = ak
        else:
            raise ValueError(f"unknown extractor: {m}")
    return zoo


def extract_keypoints_union(image, extractors: Dict[str, callable],
                            round_xy: bool = True) -> np.ndarray:
    """The union of every extractor's detections, de-duplicated on integer
    pixels (first occurrence kept, in the zoo's order)."""
    pts = [np.asarray(fn(image), np.float32).reshape(-1, 2) for fn in extractors.values()]
    xy = np.concatenate(pts, axis=0) if pts else np.zeros((0, 2), np.float32)
    if round_xy and len(xy):
        _, keep = np.unique(np.round(xy).astype(np.int64), axis=0, return_index=True)
        xy = xy[np.sort(keep)]
    return xy
