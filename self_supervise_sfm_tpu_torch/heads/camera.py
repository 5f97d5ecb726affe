"""Camera head: iterative adaLN pose regression, in fp32.

Port of ``self_supervise_sfm_tpu/heads/camera.py``. Anchor camera tokens of
the last aggregator layer and the query camera tokens are refined jointly
through ``num_iterations`` modulated passes of a block trunk under an
anchor/query allow-mask; only the query encodings are returned. The trunk's
attention takes the dense path (a boolean mask, 10 tokens).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch
import torch.nn.functional as F

from ..layers import params as P
from ..layers.block import BlockConfig, block, init_block
from .act import activate_pose


@dataclass(frozen=True)
class CameraHeadConfig:
    dim_in: int = 2048
    trunk_depth: int = 4
    target_dim: int = 9  # absT_quaR_FoV
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 0.01
    trans_act: str = "linear"
    quat_act: str = "linear"
    fl_act: str = "relu"
    num_iterations: int = 4
    attn_impl: str = "auto"

    @property
    def block_cfg(self) -> BlockConfig:
        return BlockConfig(
            dim=self.dim_in, num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            qk_norm=False, init_values=self.init_values, attn_impl=self.attn_impl,
        )


def init_camera_head(g, dev, cfg: CameraHeadConfig):
    d = cfg.dim_in
    return {
        "trunk": [init_block(g, dev, cfg.block_cfg) for _ in range(cfg.trunk_depth)],
        "token_norm": P.init_layer_norm(d, dev),
        "trunk_norm": P.init_layer_norm(d, dev),
        "empty_pose_tokens": torch.zeros((1, 1, cfg.target_dim), device=dev),
        "embed_pose": P.init_linear(g, dev, cfg.target_dim, d),
        "poseLN_modulation": P.init_linear(g, dev, d, 3 * d),
        "pose_branch": {
            "fc1": P.init_linear(g, dev, d, d // 2),
            "fc2": P.init_linear(g, dev, d // 2, cfg.target_dim),
        },
    }


def _anchor_query_allow_mask(num_anchor: int, num_query: int, device) -> torch.Tensor:
    """(1, 1, S, S) allow-mask: anchors see anchors, queries see anchors + self."""
    S = num_anchor + num_query
    is_q = torch.arange(S, device=device) >= num_anchor
    eye = torch.eye(S, dtype=torch.bool, device=device)
    allow = ~is_q[None, :] | (eye & is_q[:, None])
    return allow[None, None]


def camera_head(p, tokens_last, cam_token_last_layer,
                cfg: CameraHeadConfig) -> List[torch.Tensor]:
    """tokens_last: (B, Q, P, 2C), camera token at index 0; cam_token_last_layer:
    (B, A, 2C). Returns ``num_iterations`` (B, Q, 9) activated encodings."""
    pose_tokens = tokens_last[:, :, 0].float()
    cam = cam_token_last_layer.float()
    B, Q, _ = pose_tokens.shape
    A = cam.shape[1]
    S = A + Q
    x = P.layer_norm(p["token_norm"], torch.cat([cam, pose_tokens], dim=1))
    mask = _anchor_query_allow_mask(A, Q, x.device)
    bcfg = cfg.block_cfg

    preds: List[torch.Tensor] = []
    pred_pose_enc = None
    for _ in range(cfg.num_iterations):
        if pred_pose_enc is None:
            module_input = P.linear(
                p["embed_pose"], p["empty_pose_tokens"].expand(B, S, cfg.target_dim))
        else:
            module_input = P.linear(p["embed_pose"], pred_pose_enc)
        mod = P.linear(p["poseLN_modulation"], F.silu(module_input))
        shift, scale, gate = mod.chunk(3, dim=-1)
        normed = P.layer_norm({}, x, eps=1e-6)  # adaLN: no affine params
        modulated = gate * (normed * (1 + scale) + shift) + x
        for bp in p["trunk"]:
            modulated = block(bp, modulated, bcfg, mask=mask)
        delta = P.linear(
            p["pose_branch"]["fc2"],
            P.gelu(P.linear(p["pose_branch"]["fc1"],
                            P.layer_norm(p["trunk_norm"], modulated))),
        )
        pred_pose_enc = delta if pred_pose_enc is None else pred_pose_enc + delta
        activated = activate_pose(pred_pose_enc, cfg.trans_act, cfg.quat_act, cfg.fl_act)
        preds.append(activated[:, A:])  # queries only
    return preds
