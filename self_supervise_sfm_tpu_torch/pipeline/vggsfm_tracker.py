"""VGGSfM-variant coarse-to-fine point tracker.

Port of ``self_supervise_sfm_tpu/pipeline/vggsfm_tracker.py``, NHWC:

- ``basic_encoder``: the stride-4 residual CNN with instance norm and the
  multi-scale concat head; ``shallow_encoder``: the stride-1 CNN for the
  31 x 31 patch features;
- ``vggsfm_predictor``: the iterative predictor on raw correlation
  features, with the reference's padding of the transformer input; the fine
  predictor has no visibility head;
- ``refine_track``: coarse tracks -> patches around them -> patch features
  -> the fine predictor in patch coordinates -> image coordinates.

Every align-corners resize goes through ``heads/dpt_utils.resize_bilinear_ac``
with the config's ``resize_impl``, so the size gate picks the K3 kernel
(``csrc/resize.cu``) or the einsum path as in the JAX package. At the
demo's size the shallow encoder's last upsample, every patch of every frame
to 31 x 31, takes K3; on a CPU tensor K3's wrapper runs its plain version.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..heads.dpt_utils import resize_bilinear_ac
from ..heads.track_modules import (
    UpdateFormerConfig,
    build_fmap_pyramid,
    corr_sample,
    init_updateformer,
    updateformer,
)
from ..heads.track_utils import (bilinear_sample_batched, get_2d_embedding,
                                 get_2d_sincos_pos_embed)
from ..layers import params as P
from ..models.sailrecon import _device

_PAD1 = [(1, 1), (1, 1)]


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``InstanceNorm2d(affine=False)``: per sample and channel over H, W."""
    var, mean = torch.var_mean(x, dim=(-3, -2), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


def init_residual_block(g, device, c_in: int, c_out: int, stride: int = 1):
    p = {"conv1": P.init_conv(g, device, 3, 3, c_in, c_out),
         "conv2": P.init_conv(g, device, 3, 3, c_out, c_out)}
    if stride != 1:
        p["downsample"] = P.init_conv(g, device, 1, 1, c_in, c_out)
    return p


def residual_block(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    y = torch.relu(instance_norm(P.conv2d(p["conv1"], x, stride=stride, padding=_PAD1)))
    y = torch.relu(instance_norm(P.conv2d(p["conv2"], y, padding=_PAD1)))
    if "downsample" in p:
        x = instance_norm(P.conv2d(p["downsample"], x, stride=stride, padding="VALID"))
    return torch.relu(x + y)


def init_basic_encoder(g, device, output_dim: int = 128):
    half, three_q = output_dim // 2, output_dim // 4 * 3

    def pair(c_in, c_out, stride):
        return [init_residual_block(g, device, c_in, c_out, stride),
                init_residual_block(g, device, c_out, c_out, 1)]

    return {
        "conv1": P.init_conv(g, device, 7, 7, 3, half),
        "layer1": pair(half, half, 1),
        "layer2": pair(half, three_q, 2),
        "layer3": pair(three_q, output_dim, 2),
        "layer4": pair(output_dim, output_dim, 2),
        "conv2": P.init_conv(g, device, 3, 3, output_dim * 3 + output_dim // 4,
                             output_dim * 2),
        "conv3": P.init_conv(g, device, 1, 1, output_dim * 2, output_dim),
    }


def basic_encoder(p, x: torch.Tensor, stride: int = 4, resize_impl: str = "auto"):
    """(N, H, W, 3) -> (N, H / stride, W / stride, 128)."""
    H, W = x.shape[-3], x.shape[-2]
    y = torch.relu(instance_norm(P.conv2d(p["conv1"], x, stride=2, padding=[(3, 3), (3, 3)])))
    feats = []
    for name, s in (("layer1", 1), ("layer2", 2), ("layer3", 2), ("layer4", 2)):
        y = residual_block(p[name][0], y, s)
        y = residual_block(p[name][1], y, 1)
        feats.append(y)
    out_hw = (H // stride, W // stride)
    cat = torch.cat([resize_bilinear_ac(t, out_hw, impl=resize_impl) for t in feats], dim=-1)
    y = torch.relu(instance_norm(P.conv2d(p["conv2"], cat, padding=_PAD1)))
    return P.conv2d(p["conv3"], y, padding="VALID")


def init_shallow_encoder(g, device, output_dim: int = 32):
    return {
        "conv1": P.init_conv(g, device, 3, 3, 3, output_dim),
        "layer1": init_residual_block(g, device, output_dim, output_dim, 2),
        "layer2": init_residual_block(g, device, output_dim, output_dim, 2),
        "conv2": P.init_conv(g, device, 1, 1, output_dim, output_dim),
    }


def shallow_encoder(p, x: torch.Tensor, stride: int = 1, resize_impl: str = "auto"):
    """(N, P, P, 3) -> (N, P / stride, P / stride, 32)."""
    H, W = x.shape[-3], x.shape[-2]
    y = torch.relu(instance_norm(P.conv2d(p["conv1"], x, stride=2, padding=_PAD1)))
    hw = tuple(y.shape[-3:-1])
    tmp = residual_block(p["layer1"], y, 2)
    y = y + resize_bilinear_ac(tmp, hw, impl=resize_impl)
    tmp = residual_block(p["layer2"], tmp, 2)
    y = y + resize_bilinear_ac(tmp, hw, impl=resize_impl)
    y = P.conv2d(p["conv2"], y, padding="VALID") + y
    return resize_bilinear_ac(y, (H // stride, W // stride), impl=resize_impl)


@dataclass(frozen=True)
class VGGSfMPredictorConfig:
    stride: int = 4
    corr_levels: int = 5
    corr_radius: int = 4
    latent_dim: int = 128
    hidden_size: int = 384
    use_spaceatt: bool = True
    depth: int = 6
    fine: bool = False

    @property
    def corr_dim(self) -> int:
        return self.corr_levels * (2 * self.corr_radius + 1) ** 2

    @property
    def transformer_dim(self) -> int:
        # the reference's padding quirks (base_track_predictor.py:41-50)
        d = self.corr_dim + 2 * self.latent_dim
        if self.fine:
            return d + (4 if d % 2 == 0 else 5)
        return d + (4 - d % 4) % 4

    @property
    def updateformer_cfg(self) -> UpdateFormerConfig:
        # the VGGSfM variant: no input / output LayerNorms, affine-free eps
        # 1e-6 block norms
        return UpdateFormerConfig(
            space_depth=self.depth if self.use_spaceatt else 0,
            time_depth=self.depth,
            input_dim=self.transformer_dim,
            hidden_size=self.hidden_size,
            output_dim=self.latent_dim + 2,
            add_space_attn=self.use_spaceatt,
            use_norms=False,
            block_norm_affine=False,
            block_norm_eps=1e-6,
        )


def init_vggsfm_predictor(g, device, cfg: VGGSfMPredictorConfig):
    p = {
        "updateformer": init_updateformer(g, device, cfg.updateformer_cfg),
        "norm": P.init_layer_norm(cfg.latent_dim, device),  # GroupNorm(1, C)
        "ffeat_updater": P.init_linear(g, device, cfg.latent_dim, cfg.latent_dim),
    }
    if not cfg.fine:
        p["vis_predictor"] = P.init_linear(g, device, cfg.latent_dim, 1)
    return p


def vggsfm_predictor(p, query_points: torch.Tensor, fmaps: torch.Tensor,
                     cfg: VGGSfMPredictorConfig, iters: int = 4, down_ratio: int = 1,
                     return_feat: bool = False):
    """query_points (B, N, 2), fmaps (B, S, H, W, C) -> (coordinate
    predictions of each iteration (B, S, N, 2), visibility (B, S, N) or None
    [, track features, query features])."""
    B, N, _ = query_points.shape
    _, S, H, W, C = fmaps.shape
    qp = query_points / float(down_ratio) / float(cfg.stride)
    coords = qp[:, None].expand(B, S, N, 2)
    query_feat = bilinear_sample_batched(fmaps[:, 0], coords[:, 0])  # (B, N, C)
    track_feats = query_feat[:, None].expand(B, S, N, C)
    coords0 = coords
    pyramid = build_fmap_pyramid(fmaps, cfg.corr_levels)
    pos_grid = get_2d_sincos_pos_embed(cfg.transformer_dim, (H, W), fmaps.device)
    sampled_pos = bilinear_sample_batched(
        pos_grid[None].expand(B, H, W, cfg.transformer_dim), coords[:, 0])

    coord_preds: List[torch.Tensor] = []
    for _ in range(iters):
        fcorrs = corr_sample(pyramid, track_feats, coords, cfg.corr_radius)
        flows = (coords - coords[:, 0:1]).transpose(1, 2)
        flows_emb = get_2d_embedding(flows, cfg.latent_dim // 2, cat_coords=False)
        # the VGGSfM variant appends the raw flows to the embedding
        flows_emb = torch.cat([flows_emb, flows], dim=-1)
        tf_ = track_feats.transpose(1, 2)
        x = torch.cat([flows_emb, fcorrs.transpose(1, 2), tf_], dim=-1)
        pad = cfg.transformer_dim - x.shape[-1]
        if pad < 0:
            raise ValueError(
                f"corr/latent config overflows transformer_dim by {-pad} (the "
                "reference pads up only; pick corr_levels / corr_radius with "
                "(corr_dim + 2 * latent) % 4 >= 2 headroom)")
        if pad:
            x = torch.cat([x, x.new_zeros(*x.shape[:-1], pad)], dim=-1)
        x = x + sampled_pos[:, :, None, :]
        delta = updateformer(p["updateformer"], x, cfg.updateformer_cfg)
        upd = P.gelu(P.linear(p["ffeat_updater"], P.layer_norm(p["norm"], delta[..., 2:])))
        track_feats = (upd + tf_).transpose(1, 2)
        coords = coords + delta[..., :2].transpose(1, 2)
        coords = torch.cat([coords0[:, :1], coords[:, 1:]], dim=1)
        coord_preds.append(coords * cfg.stride * down_ratio)

    vis = None
    if not cfg.fine:
        vis = torch.sigmoid(P.linear(p["vis_predictor"], track_feats)[..., 0])
    if return_feat:
        return coord_preds, vis, track_feats, query_feat
    return coord_preds, vis


def _fine_default() -> VGGSfMPredictorConfig:
    return VGGSfMPredictorConfig(stride=1, depth=4, corr_levels=3, corr_radius=3,
                                 latent_dim=32, hidden_size=256, fine=True,
                                 use_spaceatt=False)


@dataclass(frozen=True)
class VGGSfMTrackerConfig:
    coarse: VGGSfMPredictorConfig = field(
        default_factory=lambda: VGGSfMPredictorConfig(stride=4))
    fine: VGGSfMPredictorConfig = field(default_factory=_fine_default)
    coarse_down_ratio: int = 2
    pradius: int = 15  # fine patch radius (psize 31)
    fine_iters: int = 6
    # the resizes' route (heads/dpt_utils.resize_bilinear_ac): "auto" takes
    # K3 behind the size gate, "einsum" never
    resize_impl: str = "auto"


def init_vggsfm_tracker(cfg: VGGSfMTrackerConfig, generator: torch.Generator,
                        device="cuda"):
    """Random tracker params from ``generator`` (which must live on
    ``device``)."""
    dev = _device(device)
    g = generator
    return {
        "coarse_fnet": init_basic_encoder(g, dev, cfg.coarse.latent_dim),
        "coarse_predictor": init_vggsfm_predictor(g, dev, cfg.coarse),
        "fine_fnet": init_shallow_encoder(g, dev, cfg.fine.latent_dim),
        "fine_predictor": init_vggsfm_predictor(g, dev, cfg.fine),
    }


def extract_patches(images: torch.Tensor, topleft: torch.Tensor, psize: int) -> torch.Tensor:
    """images (F, H, W, C), integer topleft (F, N, 2) -> (F, N, psize, psize,
    C), every tap clamped into the image."""
    F_, H, W, C = images.shape
    ar = torch.arange(psize, device=images.device)
    ys = torch.clamp(topleft[..., 1][..., None, None] + ar[:, None], 0, H - 1)
    xs = torch.clamp(topleft[..., 0][..., None, None] + ar[None, :], 0, W - 1)
    frame = torch.arange(F_, device=images.device).reshape(F_, 1, 1, 1)
    return images[frame, ys, xs]


def refine_track(images: torch.Tensor, fine_fnet_params, fine_predictor_params,
                 coarse_pred: torch.Tensor, cfg: VGGSfMTrackerConfig) -> torch.Tensor:
    """Patch-based refinement: images (B, S, H, W, 3), coarse_pred (B, S, N,
    2) -> refined (B, S, N, 2)."""
    B, S, N, _ = coarse_pred.shape
    H, W = images.shape[2], images.shape[3]
    pr = cfg.pradius
    psize = 2 * pr + 1
    track_int = torch.floor(coarse_pred).to(torch.int64)
    track_frac = coarse_pred - track_int
    topleft = track_int - pr
    topleft_clamped = torch.clamp(topleft, 0, min(H, W) - psize)
    patches = extract_patches(images.reshape(B * S, H, W, 3),
                              topleft_clamped.reshape(B * S, N, 2), psize)
    pf = shallow_encoder(fine_fnet_params, patches.reshape(B * S * N, psize, psize, 3),
                         stride=cfg.fine.stride, resize_impl=cfg.resize_impl)
    Cf = pf.shape[-1]
    pf = pf.reshape(B, S, N, psize, psize, Cf).transpose(1, 2).reshape(
        B * N, S, psize, psize, Cf)
    patch_query = (track_frac[:, 0] + pr).reshape(B * N, 1, 2)
    fine_lists, _, _, _ = vggsfm_predictor(fine_predictor_params, patch_query, pf, cfg.fine,
                                           iters=cfg.fine_iters, return_feat=True)
    fine = fine_lists[-1].reshape(B, N, S, 2).transpose(1, 2)
    refined = fine + topleft.to(fine.dtype)
    return torch.cat([coarse_pred[:, :1], refined[:, 1:]], dim=1)


def _add_seconds(timings, key, t0):
    """Add the seconds since ``t0`` (after the device has finished) to
    ``timings[key]``; returns the new start. No-op without ``timings``."""
    if timings is None:
        return t0
    if t0 is not None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        timings[key] = timings.get(key, 0.0) + time.perf_counter() - t0
    return time.perf_counter()


@torch.no_grad()
def track(p, images, query_points, cfg: VGGSfMTrackerConfig = VGGSfMTrackerConfig(),
          coarse_iters: int = 6, fine_tracking: bool = True, device="cuda",
          timings: Optional[dict] = None):
    """Full coarse-to-fine tracking on ``device`` (``cuda`` unless asked for
    ``cpu``). images (B, S, H, W, 3) in [0, 1], query_points (B, N, 2) in
    the first frame. Returns (fine tracks, coarse tracks, visibility):
    (B, S, N, 2) x 2 and (B, S, N). ``timings``: a dict to which the
    seconds of the coarse and the fine stage are added (each waits for the
    device)."""
    dev = _device(device)
    t0 = _add_seconds(timings, "coarse", None)
    images = torch.as_tensor(images).to(dev, torch.float32)
    query_points = torch.as_tensor(query_points).to(dev, torch.float32)
    B, S, H, W, _ = images.shape
    imgs = images.reshape(B * S, H, W, 3)
    if cfg.coarse_down_ratio > 1:
        imgs = resize_bilinear_ac(
            imgs, (H // cfg.coarse_down_ratio, W // cfg.coarse_down_ratio),
            impl=cfg.resize_impl)
    fmaps = basic_encoder(p["coarse_fnet"], imgs, stride=cfg.coarse.stride,
                          resize_impl=cfg.resize_impl)
    fmaps = fmaps.reshape(B, S, *fmaps.shape[1:])
    coarse_lists, vis = vggsfm_predictor(p["coarse_predictor"], query_points, fmaps,
                                         cfg.coarse, iters=coarse_iters,
                                         down_ratio=cfg.coarse_down_ratio)
    coarse = coarse_lists[-1]
    t0 = _add_seconds(timings, "coarse", t0)
    if not fine_tracking:
        return coarse, coarse, vis
    fine = refine_track(images, p["fine_fnet"], p["fine_predictor"], coarse, cfg)
    _add_seconds(timings, "fine", t0)
    return fine, coarse, vis
