"""Track head: DPT feature extractor + iterative point-track refinement.

Port of ``self_supervise_sfm_tpu/heads/track.py`` (the reference's
``TrackHead`` with its ``BaseTrackerPredictor``). The features come from the
DPT head in ``feature_only`` mode at ``down_ratio=2``; the tracker is the
update transformer of ``heads/track_modules.py`` with its input / output
norms and affine block norms. ``iters`` refinement steps run as a Python
loop, the coordinates detached between steps (JAX's ``stop_gradient``) and
the query frame's coordinates put back out of place after each step, so
that autograd sees every other value.

No entry point of either package calls it; its weights come from
``utils/converter.py:convert_track_head``. At 518 px the DPT's
``refinenet1`` upsample is K3's third site.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ..layers import params as P
from .dpt import DPTHeadConfig, dpt_head, init_dpt_head
from .track_modules import (
    UpdateFormerConfig, build_fmap_pyramid, corr_sample, init_updateformer, updateformer,
)
from .track_utils import bilinear_sample_batched, get_2d_embedding, get_2d_sincos_pos_embed


@dataclass(frozen=True)
class TrackHeadConfig:
    dim_in: int = 2048
    patch_size: int = 14
    features: int = 128
    iters: int = 4
    predict_conf: bool = True
    stride: int = 2
    corr_levels: int = 7
    corr_radius: int = 4
    hidden_size: int = 384
    max_scale: int = 518
    depth: int = 6
    use_spaceatt: bool = True
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    # the DPT upsamples' route (heads/dpt.py): "auto" takes K3 behind its
    # size gate, "einsum" never
    resize_impl: str = "auto"

    @property
    def flows_emb_dim(self) -> int:
        return self.features // 2

    @property
    def transformer_dim(self) -> int:
        return 3 * self.features + 4

    @property
    def feature_extractor_cfg(self) -> DPTHeadConfig:
        return DPTHeadConfig(
            dim_in=self.dim_in, patch_size=self.patch_size, features=self.features,
            feature_only=True, down_ratio=2, pos_embed=False,
            intermediate_layer_idx=self.intermediate_layer_idx,
            resize_impl=self.resize_impl,
        )

    @property
    def updateformer_cfg(self) -> UpdateFormerConfig:
        return UpdateFormerConfig(
            space_depth=self.depth if self.use_spaceatt else 0, time_depth=self.depth,
            input_dim=self.transformer_dim, hidden_size=self.hidden_size,
            output_dim=self.features + 2, add_space_attn=self.use_spaceatt,
        )


def init_track_head(g, cfg: TrackHeadConfig = TrackHeadConfig(), device="cuda"):
    """Random params from the generator ``g``, which must live on ``device``
    (``cuda`` by default: without a card that raises)."""
    from ..models.sailrecon import _device

    device = _device(device)
    corr_dim = cfg.corr_levels * (2 * cfg.corr_radius + 1) ** 2
    p = {
        "feature_extractor": init_dpt_head(g, device, cfg.feature_extractor_cfg),
        "corr_mlp": {"fc1": P.init_linear(g, device, corr_dim, cfg.hidden_size),
                     "fc2": P.init_linear(g, device, cfg.hidden_size, cfg.features)},
        "query_ref_token": P.normal((1, 2, cfg.transformer_dim), g, device),
        "updateformer": init_updateformer(g, device, cfg.updateformer_cfg),
        "fmap_norm": P.init_layer_norm(cfg.features, device),
        "ffeat_norm": P.init_layer_norm(cfg.features, device),  # GroupNorm(1, C) == LN
        "ffeat_updater": P.init_linear(g, device, cfg.features, cfg.features),
        "vis_predictor": P.init_linear(g, device, cfg.features, 1),
    }
    if cfg.predict_conf:
        p["conf_predictor"] = P.init_linear(g, device, cfg.features, 1)
    return p


def track_predictor(p, query_points: torch.Tensor, fmaps: torch.Tensor,
                    cfg: TrackHeadConfig, iters: Optional[int] = None, down_ratio: int = 1,
                    apply_sigmoid: bool = True):
    """The iterative tracker. query_points (B, N, 2) pixels at the feature
    maps' input scale; fmaps (B, S, H, W, C). Returns (coord_preds: a list
    of (B, S, N, 2), one an iteration; vis (B, S, N); conf or None)."""
    iters = iters or cfg.iters
    B, N, _ = query_points.shape
    _, S, H, W, C = fmaps.shape
    D = cfg.transformer_dim

    fmaps = P.layer_norm(p["fmap_norm"], fmaps)
    qp = query_points / float(down_ratio) / float(cfg.stride)
    coords = qp[:, None].expand(B, S, N, 2)
    coords0 = coords

    # track features start as the query frame's features at the query points
    query_feat = bilinear_sample_batched(fmaps[:, 0], coords[:, 0])  # (B, N, C)
    track_feats = query_feat[:, None].expand(B, S, N, C)
    pyramid = build_fmap_pyramid(fmaps, cfg.corr_levels)
    pos_grid = get_2d_sincos_pos_embed(D, (H, W), device=fmaps.device)
    sampled_pos = bilinear_sample_batched(pos_grid[None].expand(B, H, W, D),
                                          coords[:, 0])  # (B, N, D)
    qrt = p["query_ref_token"]
    qrt = torch.cat([qrt[:, 0:1], qrt[:, 1:2].expand(1, S - 1, D)], dim=1)  # (1, S, D)

    coord_preds = []
    for _ in range(iters):
        coords = coords.detach()
        fcorrs = corr_sample(pyramid, track_feats, coords, cfg.corr_radius)
        fcorrs = fcorrs.transpose(1, 2)  # (B, N, S, L)
        fcorrs = P.linear(p["corr_mlp"]["fc2"], P.gelu(P.linear(p["corr_mlp"]["fc1"], fcorrs)))

        flows = (coords - coords[:, 0:1]).transpose(1, 2)  # (B, N, S, 2)
        flows_emb = get_2d_embedding(flows, cfg.flows_emb_dim, cat_coords=False)
        flows_emb = torch.cat([flows_emb, flows / cfg.max_scale, flows / cfg.max_scale],
                              dim=-1)

        tf = track_feats.transpose(1, 2)  # (B, N, S, C)
        x = torch.cat([flows_emb, fcorrs, tf], dim=-1)
        x = x + sampled_pos[:, :, None, :]
        x = x + qrt[None].to(x.dtype)

        delta = updateformer(p["updateformer"], x, cfg.updateformer_cfg)
        delta_coords, delta_feats = delta[..., :2], delta[..., 2:]
        upd = P.gelu(P.linear(p["ffeat_updater"],
                              P.layer_norm(p["ffeat_norm"], delta_feats)))
        track_feats = (upd + tf).transpose(1, 2)  # (B, S, N, C)

        coords = coords + delta_coords.transpose(1, 2)
        # the query frame stays where it was put
        coords = torch.cat([coords0[:, :1], coords[:, 1:]], dim=1)
        coord_preds.append(coords * cfg.stride * down_ratio)

    vis = P.linear(p["vis_predictor"], track_feats)[..., 0]
    conf = P.linear(p["conf_predictor"], track_feats)[..., 0] if cfg.predict_conf else None
    if apply_sigmoid:
        vis = torch.sigmoid(vis)
        conf = torch.sigmoid(conf) if conf is not None else None
    return coord_preds, vis, conf


def track_head(p, taps: Dict[int, torch.Tensor], images_hw: Tuple[int, int],
               patch_start_idx: int, query_points: torch.Tensor, cfg: TrackHeadConfig,
               iters: Optional[int] = None):
    """The whole head: DPT features, then the tracker. ``query_points``
    (B, N, 2) in pixels of the image; returns (coord_preds, vis, conf) with
    the coordinates at the image's scale."""
    fmaps = dpt_head(p["feature_extractor"], taps, images_hw, patch_start_idx,
                     cfg.feature_extractor_cfg)  # (B, S, H / 2, W / 2, features)
    return track_predictor(p, query_points, fmaps, cfg, iters=iters, down_ratio=1)
