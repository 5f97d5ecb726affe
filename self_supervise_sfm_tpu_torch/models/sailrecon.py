"""SailRecon facade: aggregator + camera / point / depth heads.

Port of ``self_supervise_sfm_tpu/models/sailrecon.py`` (the joint
``forward``; scene-cache build and reloc are later slices). Heads always
run in fp32 whatever the trunk dtype. The entry points run on ``cuda``
unless the caller passes ``device="cpu"``; without a card they raise rather
than carry on on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..heads.camera import CameraHeadConfig, camera_head, init_camera_head
from ..heads.dpt import DPTHeadConfig, dpt_head, init_dpt_head
from ..layers.vit import ViTConfig
from ..ops import geometry as G
from .aggregator import AggregatorConfig, aggregator_forward, init_aggregator


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
    PyTorch instead."""
    vit = ViTConfig(
        img_size=img_size, patch_size=patch_size,
        embed_dim=vit_embed_dim or embed_dim, depth=vit_depth,
        num_heads=vit_num_heads or num_heads, attn_impl=attn_impl,
        fused_qkv=fused_qkv, fused_mlp=fused_mlp,
    )
    agg = AggregatorConfig(
        img_size=img_size, patch_size=patch_size, embed_dim=embed_dim, depth=depth,
        num_heads=num_heads, intermediate_layer_idx=tuple(intermediate_layer_idx),
        vit=vit, compute_dtype=compute_dtype, attn_impl=attn_impl,
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
    dev = _device(device)
    ref = p["aggregator"]["vit"]["pos_embed"]
    if ref.device.type != dev.type:
        raise ValueError(f"params live on {ref.device}, the forward runs on {dev}")
    if isinstance(images, np.ndarray):
        images = torch.from_numpy(images)
    images = images.to(dev, torch.float32)
    H, W = images.shape[2], images.shape[3]
    taps, psi, cam_tok = aggregator_forward(
        p["aggregator"], cfg.aggregator, images, num_anchor, num_query, rank,
        generator, subsample_indices, images_duplicated,
    )
    return _decode_heads(p, cfg, taps, cam_tok, (H, W), psi)
