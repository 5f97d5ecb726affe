"""SailRecon facade: aggregator + camera / point / depth heads.

Port of ``self_supervise_sfm_tpu/models/sailrecon.py``: the joint
``forward`` and ``pose_forward``, and two-phase serving
(``build_scene_cache`` then ``reloc``, with the chunked and host-staged
variants of each). Heads always run in fp32 whatever the trunk dtype. The
entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than carry on on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..heads.camera import CameraHeadConfig, camera_head, init_camera_head
from ..heads.dpt import DPTHeadConfig, dpt_head, init_dpt_head
from ..layers.vit import ViTConfig
from ..ops import geometry as G
from .aggregator import (
    AggregatorConfig, aggregator_build_cache, aggregator_build_cache_staged,
    aggregator_forward, aggregator_reloc, aggregator_reloc_staged,
    init_aggregator,
)


@dataclass(frozen=True)
class SailReconConfig:
    aggregator: AggregatorConfig = field(default_factory=AggregatorConfig)
    camera: CameraHeadConfig = field(default_factory=CameraHeadConfig)
    point: DPTHeadConfig = field(
        default_factory=lambda: DPTHeadConfig(output_dim=4, activation="inv_log"))
    depth: DPTHeadConfig = field(
        default_factory=lambda: DPTHeadConfig(output_dim=2, activation="exp"))
    enable_camera: bool = True
    enable_point: bool = True
    enable_depth: bool = True

    @property
    def img_size(self) -> int:
        return self.aggregator.img_size


def make_config(
    img_size: int = 518,
    patch_size: int = 14,
    embed_dim: int = 1024,
    depth: int = 24,
    num_heads: int = 16,
    vit_depth: int = 24,
    vit_embed_dim: Optional[int] = None,
    vit_num_heads: Optional[int] = None,
    intermediate_layer_idx=(4, 11, 17, 23),
    compute_dtype: str = "float32",
    remat: bool = False,
    vit_remat: bool = False,
    attn_impl: str = "auto",
    global_attn_impl: str = "auto",
    resize_impl: str = "auto",
    fused_qkv: str = "auto",
    fused_mlp: str = "auto",
) -> SailReconConfig:
    """A consistent config tree; the defaults are ViT-L/14 at 518 px with 24
    aggregator layers. With ``compute_dtype="bfloat16"`` and nothing else
    said, every trunk block runs the fused LN+QKV / out-proj / MLP kernels
    (``fused_qkv`` / ``fused_mlp`` "auto"); the fp32 camera head stays
    unfused. ``attn_impl="dense"``, ``resize_impl="einsum"`` and
    ``fused_qkv="off", fused_mlp="off"`` run every kernel site through plain
    PyTorch instead. ``remat`` checkpoints each aggregator layer and
    ``vit_remat`` each ViT block for the backward."""
    vit = ViTConfig(
        img_size=img_size, patch_size=patch_size,
        embed_dim=vit_embed_dim or embed_dim, depth=vit_depth,
        num_heads=vit_num_heads or num_heads, attn_impl=attn_impl,
        fused_qkv=fused_qkv, fused_mlp=fused_mlp, remat=vit_remat,
    )
    agg = AggregatorConfig(
        img_size=img_size, patch_size=patch_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, intermediate_layer_idx=tuple(intermediate_layer_idx),
        vit=vit, compute_dtype=compute_dtype, remat=remat, attn_impl=attn_impl,
        global_attn_impl=global_attn_impl, fused_qkv=fused_qkv, fused_mlp=fused_mlp,
    )
    head_kw = dict(
        dim_in=2 * embed_dim, patch_size=patch_size,
        intermediate_layer_idx=tuple(intermediate_layer_idx),
        # the final full-res upsample stores in the trunk dtype; its consumer
        # conv multiplies those values with fp32 accumulation
        final_upsample_dtype=compute_dtype, resize_impl=resize_impl,
    )
    return SailReconConfig(
        aggregator=agg,
        camera=CameraHeadConfig(dim_in=2 * embed_dim, attn_impl=attn_impl),
        point=DPTHeadConfig(output_dim=4, activation="inv_log", **head_kw),
        depth=DPTHeadConfig(output_dim=2, activation="exp", **head_kw),
    )


def _device(device) -> torch.device:
    """The entry points' device, with the fp32 matmul/conv precision pinned.

    TF32 is turned off for matmuls and cuDNN convolutions: the GPU twin of
    the JAX package's fp32 pinning for poses and heads (its
    ``ops/geometry.py:f32_matmul``), since PyTorch runs fp32 convs in TF32
    by default.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def init_sailrecon(cfg: SailReconConfig, generator: torch.Generator,
                   device="cuda") -> Dict[str, Any]:
    """Random params from ``generator`` (which must live on ``device``)."""
    dev = _device(device)
    g = generator
    p: Dict[str, Any] = {"aggregator": init_aggregator(g, dev, cfg.aggregator)}
    if cfg.enable_camera:
        p["camera_head"] = init_camera_head(g, dev, cfg.camera)
    if cfg.enable_point:
        p["point_head"] = init_dpt_head(g, dev, cfg.point)
    if cfg.enable_depth:
        p["depth_head"] = init_dpt_head(g, dev, cfg.depth)
    return p


# parent keys of the trunk's big matmul/conv weights; their "w" leaves may be
# held in the compute dtype (every consumer casts to x's dtype anyway)
_CASTABLE_PARENTS = frozenset({"qkv", "proj", "fc1", "fc2", "w12", "w3"})


def cast_trunk_weights(p, cfg: SailReconConfig):
    """Cast the aggregator's large matmul/conv weights to the compute dtype,
    once (bit-identical to the per-call casts). Heads, norms, biases and
    layer-scales stay fp32."""
    dtype = cfg.aggregator.dtype
    if dtype == torch.float32:
        return p

    def walk(node, parent):
        if isinstance(node, dict):
            return {
                k: (v.to(dtype) if k == "w" and parent in _CASTABLE_PARENTS
                    and torch.is_tensor(v) and v.dim() >= 2 else walk(v, k))
                for k, v in node.items()
            }
        if isinstance(node, list):
            return [walk(v, parent) for v in node]
        return node

    return {**p, "aggregator": walk(p["aggregator"], "aggregator")}


def _decode_heads(p, cfg, taps, cam_token_last_layer, images_hw, patch_start_idx):
    """Head decoding, everything fp32."""
    H, W = images_hw
    predictions: Dict[str, Any] = {}
    extrinsic = intrinsic = None
    if cfg.enable_camera:
        cam_maps = camera_head(p["camera_head"], taps[-1], cam_token_last_layer,
                               cfg.camera)
        extrinsic, intrinsic = G.pose_encoding_to_extri_intri(cam_maps[-1], (H, W))
        predictions["pose_enc_list"] = cam_maps
        predictions["extrinsic"] = extrinsic
        predictions["intrinsic"] = intrinsic
    if cfg.enable_point:
        xyz_map, xyz_conf = dpt_head(p["point_head"], taps, (H, W), patch_start_idx,
                                     cfg.point)
        predictions["point_map"] = xyz_map
        predictions["xyz_cnf"] = xyz_conf
    if cfg.enable_depth:
        dpt_map, dpt_conf = dpt_head(p["depth_head"], taps, (H, W), patch_start_idx,
                                     cfg.depth)
        predictions["depth_map"] = dpt_map
        predictions["dpt_cnf"] = dpt_conf
        if extrinsic is not None:
            predictions["point_map_by_unprojection"] = G.unproject_depth_to_world(
                dpt_map[..., 0], extrinsic, intrinsic)
    predictions["cam_tokens"] = taps[-1][:, :, 0]
    return predictions


def forward(
    p, cfg: SailReconConfig, images, num_anchor: int, num_query: int,
    rank: int = 300, generator: Optional[torch.Generator] = None,
    subsample_indices=None, images_duplicated: bool = False, device="cuda",
) -> Dict[str, Any]:
    """Joint forward. images: (B, A+Q, H, W, 3) NHWC in [0, 1], anchors first.

    ``generator`` draws the per-layer scene-token subsample (or pass explicit
    patch-relative ``subsample_indices`` (depth, B, A, rank)).
    ``images_duplicated``: frames [A:] repeat frames [:A]; the ViT then runs
    once per unique image.
    Returns per-query-frame predictions with leading dims (B, Q): extrinsic
    (3, 4), intrinsic (3, 3), point_map (H, W, 3), xyz_cnf (H, W), depth_map
    (H, W, 1), dpt_cnf (H, W), point_map_by_unprojection (H, W, 3),
    cam_tokens (2C), pose_enc_list.
    """
    dev, images = _inputs(p, images, device)
    H, W = images.shape[2], images.shape[3]
    taps, psi, cam_tok = aggregator_forward(
        p["aggregator"], cfg.aggregator, images, num_anchor, num_query, rank,
        generator, subsample_indices, images_duplicated,
    )
    return _decode_heads(p, cfg, taps, cam_tok, (H, W), psi)


def _inputs(p, images, device) -> Tuple[torch.device, torch.Tensor]:
    """The entry points' device (see :func:`_device`) and the images on it
    as fp32; raises when the params live elsewhere."""
    dev = _device(device)
    ref = p["aggregator"]["vit"]["pos_embed"]
    if ref.device.type != dev.type:
        raise ValueError(f"params live on {ref.device}, the call runs on {dev}")
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    return dev, images.to(dev, torch.float32)


def pose_forward(
    p, cfg: SailReconConfig, images, num_anchor: int, num_query: int,
    rank: Optional[int] = None, generator: Optional[torch.Generator] = None,
    fp64_decode: bool = False, device="cuda",
):
    """Pose-only evaluation: aggregator + camera head, no dense heads.

    Returns (extrinsics (B, Q, 3, 4), intrinsics (B, Q, 3, 3)). ``rank``
    defaults to every patch token. ``fp64_decode=True`` decodes the final
    encoding on the host in float64 and returns numpy arrays.
    """
    dev, images = _inputs(p, images, device)
    H, W = images.shape[2], images.shape[3]
    acfg = cfg.aggregator
    P0 = (H // acfg.patch_size) * (W // acfg.patch_size)
    taps, _, cam_tok = aggregator_forward(
        p["aggregator"], acfg, images, num_anchor, num_query,
        rank if rank is not None else P0, generator)
    cam_maps = camera_head(p["camera_head"], taps[-1], cam_tok, cfg.camera)
    if fp64_decode:
        return G.pose_encoding_to_extri_intri_np64(
            cam_maps[-1].cpu().numpy(), (H, W))
    return G.pose_encoding_to_extri_intri(cam_maps[-1], (H, W))


def build_scene_cache(
    p, cfg: SailReconConfig, anchor_images, rank: int = 300,
    generator: Optional[torch.Generator] = None, subsample_indices=None,
    anchor_chunk: Optional[int] = None, chunk_embed: bool = True, device="cuda",
):
    """Phase 1 of two-phase serving: (cache, cam_token_last_layer) of the
    anchors (B, A, H, W, 3).

    ``anchor_chunk``: anchor-chunked build (it must divide the anchor count,
    else the one-shot layer runs); per-layer transients then scale with the
    chunk instead of the scene. ``chunk_embed=False`` keeps the ViT patch
    embedding unchunked. The cache is ``{"kv": (depth, B, heads,
    A * (rank + 5), 2 * head_dim)}`` on the device.
    """
    _, images = _inputs(p, anchor_images, device)
    return aggregator_build_cache(
        p["aggregator"], cfg.aggregator, images, rank, generator,
        subsample_indices, anchor_chunk=anchor_chunk, chunk_embed=chunk_embed)


def _with_conf_fractions(preds: Dict[str, Any]) -> Dict[str, Any]:
    if "xyz_cnf" in preds:
        # per-view fraction of point confidence above thresholds 1.0 .. 5.25
        cnf = preds["xyz_cnf"]  # (B, Q, H, W)
        thresholds = torch.arange(1.0, 5.5, 0.25, device=cnf.device)
        preds["xyz_conf_fractions"] = (
            (cnf[..., None] > thresholds).float().mean(dim=(2, 3)))
    return preds


def _decode_reloc(p, cfg, taps, psi, cam_tok, images_hw, fast_reloc: bool):
    if fast_reloc:  # the camera head only
        cam_maps = camera_head(p["camera_head"], taps[-1], cam_tok, cfg.camera)
        extrinsic, intrinsic = G.pose_encoding_to_extri_intri(cam_maps[-1], images_hw)
        return {"extrinsic": extrinsic, "intrinsic": intrinsic,
                "pose_enc_list": cam_maps}
    return _with_conf_fractions(
        _decode_heads(p, cfg, taps, cam_tok, images_hw, psi))


def reloc(
    p, cfg: SailReconConfig, cache, cam_token_last_layer, images,
    fast_reloc: bool = False, device="cuda",
) -> Dict[str, Any]:
    """Phase 2: localise (B, Q, H, W, 3) query frames against the cache.

    The cache lives on the device (move a host cache there first, or use
    :func:`reloc_staged`). ``fast_reloc=True`` decodes camera parameters
    only. The full decode adds ``xyz_conf_fractions`` (B, Q, 18).
    """
    dev, images = _inputs(p, images, device)
    if cache["kv"].device.type != dev.type:
        raise ValueError(
            f"the cache lives on {cache['kv'].device}, reloc runs on {dev}: "
            "move it there, or use reloc_staged for a host cache")
    H, W = images.shape[2], images.shape[3]
    taps, psi = aggregator_reloc(p["aggregator"], cfg.aggregator, cache, images)
    cam_tok = torch.as_tensor(cam_token_last_layer).to(dev)
    return _decode_reloc(p, cfg, taps, psi, cam_tok, (H, W), fast_reloc)


def build_scene_cache_staged(
    p, cfg: SailReconConfig, anchor_images, rank: int = 300,
    generator: Optional[torch.Generator] = None, subsample_indices=None,
    num_segments: int = 4, anchor_chunk: Optional[int] = None,
    chunk_embed: bool = True, device="cuda",
):
    """Host-staged phase 1: the scene is bounded by host RAM, not device
    memory. The cache streams to the host segment by segment as it is built.
    Returns a host cache ``{"kv": CPU tensor}`` (pinned when built on a card)
    and the cam token as a CPU tensor, for :func:`reloc_staged`."""
    _, images = _inputs(p, anchor_images, device)
    return aggregator_build_cache_staged(
        p["aggregator"], cfg.aggregator, images, rank, generator,
        subsample_indices, num_segments, anchor_chunk=anchor_chunk,
        chunk_embed=chunk_embed)


def reloc_staged(
    p, cfg: SailReconConfig, host_cache, cam_token_last_layer, images,
    num_segments: int = 4, fast_reloc: bool = False, device="cuda",
) -> Dict[str, Any]:
    """:func:`reloc` against a host-RAM cache, uploading one layer segment at
    a time (device peak: query activations + one segment's kv2 tensor)."""
    dev, images = _inputs(p, images, device)
    H, W = images.shape[2], images.shape[3]
    taps, psi = aggregator_reloc_staged(
        p["aggregator"], cfg.aggregator, host_cache, images, num_segments)
    cam_tok = torch.as_tensor(cam_token_last_layer).to(dev)
    return _decode_reloc(p, cfg, taps, psi, cam_tok, (H, W), fast_reloc)


def reloc_chunked(
    p, cfg: SailReconConfig, cache, cam_token_last_layer, images,
    chunk: int = 4, fast_reloc: bool = False, device="cuda",
) -> Dict[str, Any]:
    """:func:`reloc` over query chunks: activation and head-decode memory is
    that of ``chunk`` frames instead of Q while the cache stays resident. Q
    is padded up to a multiple of ``chunk`` with zero images; the padded
    frames are dropped from every output."""
    dev, images = _inputs(p, images, device)
    Q = images.shape[1]
    nchunk = -(-Q // chunk)
    pad = nchunk * chunk - Q
    if pad:
        images = torch.cat(
            [images, images.new_zeros((images.shape[0], pad, *images.shape[2:]))],
            dim=1)
    parts = [
        reloc(p, cfg, cache, cam_token_last_layer,
              images[:, c * chunk: (c + 1) * chunk], fast_reloc=fast_reloc,
              device=dev)
        for c in range(nchunk)
    ]

    def unfold(leaves):
        return torch.cat(leaves, dim=1)[:, :Q]

    return {
        k: (unfold([part[k] for part in parts]) if k != "pose_enc_list"
            else [unfold(xs) for xs in zip(*(part[k] for part in parts))])
        for k in parts[0]
    }
