"""DPT dense-prediction head (depth / point maps + confidence).

Port of ``self_supervise_sfm_tpu/heads/dpt.py``: NHWC activations, fp32
throughout, align-corners resizes. The final full-resolution upsample may
store in bf16 (``final_upsample_dtype``) and then feeds a conv that
multiplies the bf16 values with fp32 accumulation; on the card it is the K3
kernel with the pos-embed addend fused.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..layers import params as P
from .act import activate_head
from .dpt_utils import create_uv_grid, position_grid_to_embed, resize_bilinear_ac

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class DPTHeadConfig:
    dim_in: int = 2048
    patch_size: int = 14
    output_dim: int = 4  # (C-1) values + 1 confidence
    activation: str = "inv_log"
    conf_activation: str = "expp1"
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    pos_embed: bool = True
    feature_only: bool = False
    down_ratio: int = 1
    final_upsample_dtype: str = "float32"
    # resize path of every upsample: "auto" (K3 kernel behind the size gate),
    # "kernel" (K3 wrapper wherever it applies) or "einsum" (never)
    resize_impl: str = "auto"


def _init_rcu(g, dev, f):
    return {"conv1": P.init_conv(g, dev, 3, 3, f, f),
            "conv2": P.init_conv(g, dev, 3, 3, f, f)}


def _init_fusion(g, dev, f, has_residual):
    p = {"resConfUnit2": _init_rcu(g, dev, f),
         "out_conv": P.init_conv(g, dev, 1, 1, f, f)}
    if has_residual:
        p["resConfUnit1"] = _init_rcu(g, dev, f)
    return p


def init_dpt_head(g, dev, cfg: DPTHeadConfig):
    f = cfg.features
    oc = cfg.out_channels
    p = {
        "norm": P.init_layer_norm(cfg.dim_in, dev),
        "projects": [P.init_conv(g, dev, 1, 1, cfg.dim_in, oc[i]) for i in range(4)],
        "resize0": P.init_conv_transpose(g, dev, 4, 4, oc[0], oc[0]),
        "resize1": P.init_conv_transpose(g, dev, 2, 2, oc[1], oc[1]),
        "resize3": P.init_conv(g, dev, 3, 3, oc[3], oc[3]),
        "scratch": {
            "layer1_rn": P.init_conv(g, dev, 3, 3, oc[0], f, bias=False),
            "layer2_rn": P.init_conv(g, dev, 3, 3, oc[1], f, bias=False),
            "layer3_rn": P.init_conv(g, dev, 3, 3, oc[2], f, bias=False),
            "layer4_rn": P.init_conv(g, dev, 3, 3, oc[3], f, bias=False),
            "refinenet1": _init_fusion(g, dev, f, True),
            "refinenet2": _init_fusion(g, dev, f, True),
            "refinenet3": _init_fusion(g, dev, f, True),
            "refinenet4": _init_fusion(g, dev, f, False),
        },
    }
    if cfg.feature_only:
        p["scratch"]["output_conv1"] = P.init_conv(g, dev, 3, 3, f, f)
    else:
        p["scratch"]["output_conv1"] = P.init_conv(g, dev, 3, 3, f, f // 2)
        p["scratch"]["output_conv2"] = {
            "conv1": P.init_conv(g, dev, 3, 3, f // 2, 32),
            "conv2": P.init_conv(g, dev, 1, 1, 32, cfg.output_dim),
        }
    return p


def _rcu(p, x):
    """Residual conv unit. The reference's first ``ReLU(inplace=True)``
    mutates its input, so the skip adds ``relu(x)``:
    ``y = conv2(relu(conv1(relu(x)))) + relu(x)``."""
    a = F.relu(x)
    out = F.relu(P.conv2d(p["conv1"], a))
    return P.conv2d(p["conv2"], out) + a


def _fusion(p, x, residual=None, out_hw=None, resize_impl="auto"):
    """FeatureFusionBlock."""
    if residual is not None:
        x = x + _rcu(p["resConfUnit1"], residual)
    x = _rcu(p["resConfUnit2"], x)
    if out_hw is None:
        out_hw = (x.shape[1] * 2, x.shape[2] * 2)
    x = resize_bilinear_ac(x, out_hw, impl=resize_impl)
    return P.conv2d(p["out_conv"], x)


def _pos_embed_grid(ph, pw, C, W, H, dtype, device, ratio: float = 0.1):
    """The scaled (ph, pw, C) sincos UV positional grid addend."""
    grid = create_uv_grid(pw, ph, aspect_ratio=W / H, dtype=dtype, device=device)
    return (ratio * position_grid_to_embed(grid, C)).to(dtype)


def _apply_pos_embed(x, W: int, H: int, ratio: float = 0.1):
    pe = _pos_embed_grid(x.shape[1], x.shape[2], x.shape[-1], W, H, x.dtype,
                         x.device, ratio)
    return x + pe[None]


def dpt_head(p, taps: Dict[int, torch.Tensor], images_hw: Tuple[int, int],
             patch_start_idx: int, cfg: DPTHeadConfig):
    """Decode tapped aggregator features into dense maps.

    taps: layer index -> (B, S, P, dim_in) fp32 features.
    Returns (preds (B, S, H, W, output_dim-1), conf (B, S, H, W)), or the
    (B, S, H', W', features) map when ``feature_only``.
    """
    H, W = images_hw
    ph, pw = H // cfg.patch_size, W // cfg.patch_size
    ref = taps[cfg.intermediate_layer_idx[0]]
    B, S = ref.shape[0], ref.shape[1]

    resize_ops = [
        lambda x: P.conv_transpose2d(p["resize0"], x, 4),
        lambda x: P.conv_transpose2d(p["resize1"], x, 2),
        lambda x: x,
        lambda x: P.conv2d(p["resize3"], x, stride=2, padding=[(1, 1), (1, 1)]),
    ]
    pyramid = []
    for i, layer_idx in enumerate(cfg.intermediate_layer_idx):
        x = taps[layer_idx][:, :, patch_start_idx:].float()
        x = P.layer_norm(p["norm"], x.reshape(B * S, ph * pw, cfg.dim_in))
        x = P.conv2d(p["projects"][i], x.reshape(B * S, ph, pw, cfg.dim_in))
        if cfg.pos_embed:
            x = _apply_pos_embed(x, W, H)
        pyramid.append(resize_ops[i](x))

    s = p["scratch"]
    l1, l2, l3, l4 = (P.conv2d(s[f"layer{i + 1}_rn"], t) for i, t in enumerate(pyramid))
    ri = cfg.resize_impl
    out = _fusion(s["refinenet4"], l4, out_hw=l3.shape[1:3], resize_impl=ri)
    out = _fusion(s["refinenet3"], out, l3, out_hw=l2.shape[1:3], resize_impl=ri)
    out = _fusion(s["refinenet2"], out, l2, out_hw=l1.shape[1:3], resize_impl=ri)
    out = _fusion(s["refinenet1"], out, l1, resize_impl=ri)

    out = P.conv2d(s["output_conv1"], out)
    out_hw = (int(ph * cfg.patch_size / cfg.down_ratio),
              int(pw * cfg.patch_size / cfg.down_ratio))
    up_dtype = _DTYPES[cfg.final_upsample_dtype]
    up_dtype = None if up_dtype == out.dtype else up_dtype
    pe = None
    if cfg.pos_embed:
        pe = _pos_embed_grid(out_hw[0], out_hw[1], out.shape[-1], W, H, out.dtype,
                             out.device)
    out = resize_bilinear_ac(out, out_hw, add=pe, out_dtype=up_dtype, impl=ri)
    if cfg.feature_only:
        return out.reshape(B, S, *out.shape[1:])

    # fp32 accumulation keeps the math identical when the upsample stored bf16
    accum = torch.float32 if out.dtype != torch.float32 else None
    out = P.conv2d(s["output_conv2"]["conv1"], out, accum_dtype=accum)
    out = P.conv2d(s["output_conv2"]["conv2"], F.relu(out))
    preds, conf = activate_head(out, cfg.activation, cfg.conf_activation)
    return preds.reshape(B, S, *preds.shape[1:]), conf.reshape(B, S, *conf.shape[1:])
