"""Reference PyTorch checkpoint -> the port's parameter tree.

Port of ``self_supervise_sfm_tpu/utils/converter.py``. It maps the
reference ``SailRecon`` state dict (the published SAIL-Recon
``sailrecon.pt``), the reference ``TrackHead`` and the VGGSfM tracker
(``vggsfm_v2_tracker.pt``) onto the port's trees, the same trees that
``convert.from_jax_params`` makes of the JAX package's:

- Linear: torch (out, in) -> ``w`` (in, out), transposed and contiguous;
- Conv2d (O, I, H, W) and ConvTranspose2d (I, O, H, W): kept as they are,
  PyTorch's own layout, which ``layers/params.py`` takes (the JAX
  converter permutes both to HWIO);
- LayerNorm weight / bias -> ``scale`` / ``bias``;
- depth-stacked blocks -> a list of per-layer trees (the JAX converter
  stacks them for ``lax.scan``).

A state dict is a mapping of names to numpy arrays or tensors; the leaves
come out as CPU tensors in their own dtype (``load_torch_state_dict`` reads
a file in fp32).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Mapping[str, object]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a ``.pt`` checkpoint on the CPU: a bare state dict or one inside
    a ``{"state_dict": ...}`` wrapper, every leaf upcast to fp32 (as the JAX
    package's ``.float()``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float() for k, v in sd.items()}


def torch_module_to_state_dict(module) -> Dict[str, torch.Tensor]:
    """A live module's state dict as fp32 CPU tensors."""
    return {k: v.detach().float().cpu() for k, v in module.state_dict().items()}


# -- primitives -------------------------------------------------------------


def _tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v, order="C"))


def _get(sd: StateDict, name: str) -> torch.Tensor:
    return _tensor(sd[name]).contiguous()


def convert_linear(sd: StateDict, prefix: str):
    p = {"w": _tensor(sd[f"{prefix}.weight"]).T.contiguous()}
    if f"{prefix}.bias" in sd:
        p["b"] = _get(sd, f"{prefix}.bias")
    return p


def convert_ln(sd: StateDict, prefix: str):
    return {"scale": _get(sd, f"{prefix}.weight"), "bias": _get(sd, f"{prefix}.bias")}


def convert_conv(sd: StateDict, prefix: str):
    """Conv2d (O, I, kh, kw), the layout ``layers/params.py:conv2d`` takes."""
    p = {"w": _get(sd, f"{prefix}.weight")}
    if f"{prefix}.bias" in sd:
        p["b"] = _get(sd, f"{prefix}.bias")
    return p


# ConvTranspose2d (I, O, kh, kw), the layout ``conv_transpose2d`` takes
convert_conv_transpose = convert_conv


# -- transformer block ------------------------------------------------------


def convert_attention(sd: StateDict, prefix: str, qk_norm: bool):
    p = {"qkv": convert_linear(sd, f"{prefix}.qkv"),
         "proj": convert_linear(sd, f"{prefix}.proj")}
    if qk_norm:
        p["q_norm"] = convert_ln(sd, f"{prefix}.q_norm")
        p["k_norm"] = convert_ln(sd, f"{prefix}.k_norm")
    return p


def convert_block(sd: StateDict, prefix: str, qk_norm: bool):
    return {
        "norm1": convert_ln(sd, f"{prefix}.norm1"),
        "attn": convert_attention(sd, f"{prefix}.attn", qk_norm),
        "ls1": {"gamma": _get(sd, f"{prefix}.ls1.gamma")},
        "norm2": convert_ln(sd, f"{prefix}.norm2"),
        "mlp": {"fc1": convert_linear(sd, f"{prefix}.mlp.fc1"),
                "fc2": convert_linear(sd, f"{prefix}.mlp.fc2")},
        "ls2": {"gamma": _get(sd, f"{prefix}.ls2.gamma")},
    }


def convert_blocks(sd: StateDict, prefix: str, depth: int, qk_norm: bool):
    """Blocks ``prefix.0`` .. ``prefix.{depth-1}`` as a per-layer list (the
    JAX package's ``convert_blocks_stacked`` stacks the same trees)."""
    return [convert_block(sd, f"{prefix}.{i}", qk_norm) for i in range(depth)]


# -- aggregator / heads / full model ---------------------------------------


def convert_aggregator(sd: StateDict, prefix: str, depth: int, vit_depth: int):
    pfx = f"{prefix}." if prefix else ""
    return {
        "vit": convert_vit(sd, f"{pfx}patch_embed", vit_depth),
        "frame_blocks": convert_blocks(sd, f"{pfx}frame_blocks", depth, qk_norm=True),
        "global_blocks": convert_blocks(sd, f"{pfx}global_blocks", depth, qk_norm=True),
        # the reference names the reloc stack "global_reloc_blocks"
        "reloc_blocks": convert_blocks(sd, f"{pfx}global_reloc_blocks", depth,
                                       qk_norm=True),
        "camera_token": _get(sd, f"{pfx}camera_token"),
        "register_token": _get(sd, f"{pfx}register_token"),
        "camera_token_reloc": _get(sd, f"{pfx}camera_token_reloc"),
        "register_token_reloc": _get(sd, f"{pfx}register_token_reloc"),
    }


def convert_camera_head(sd: StateDict, prefix: str, trunk_depth: int = 4):
    pfx = f"{prefix}." if prefix else ""
    return {
        "trunk": convert_blocks(sd, f"{pfx}trunk", trunk_depth, qk_norm=False),
        "token_norm": convert_ln(sd, f"{pfx}token_norm"),
        "trunk_norm": convert_ln(sd, f"{pfx}trunk_norm"),
        "empty_pose_tokens": _get(sd, f"{pfx}empty_pose_tokens"),
        "embed_pose": convert_linear(sd, f"{pfx}embed_pose"),
        # torch: nn.Sequential(SiLU, Linear), index 1 is the Linear
        "poseLN_modulation": convert_linear(sd, f"{pfx}poseLN_modulation.1"),
        "pose_branch": {"fc1": convert_linear(sd, f"{pfx}pose_branch.fc1"),
                        "fc2": convert_linear(sd, f"{pfx}pose_branch.fc2")},
    }


def _convert_rcu(sd: StateDict, prefix: str):
    return {"conv1": convert_conv(sd, f"{prefix}.conv1"),
            "conv2": convert_conv(sd, f"{prefix}.conv2")}


def _convert_fusion(sd: StateDict, prefix: str, has_residual: bool):
    p = {"resConfUnit2": _convert_rcu(sd, f"{prefix}.resConfUnit2"),
         "out_conv": convert_conv(sd, f"{prefix}.out_conv")}
    if has_residual:
        p["resConfUnit1"] = _convert_rcu(sd, f"{prefix}.resConfUnit1")
    return p


def convert_dpt_head(sd: StateDict, prefix: str, feature_only: bool = False):
    pfx = f"{prefix}." if prefix else ""
    s = f"{pfx}scratch"
    p = {
        "norm": convert_ln(sd, f"{pfx}norm"),
        "projects": [convert_conv(sd, f"{pfx}projects.{i}") for i in range(4)],
        "resize0": convert_conv_transpose(sd, f"{pfx}resize_layers.0"),
        "resize1": convert_conv_transpose(sd, f"{pfx}resize_layers.1"),
        "resize3": convert_conv(sd, f"{pfx}resize_layers.3"),
        "scratch": {
            **{f"layer{i}_rn": convert_conv(sd, f"{s}.layer{i}_rn") for i in (1, 2, 3, 4)},
            **{f"refinenet{i}": _convert_fusion(sd, f"{s}.refinenet{i}", i != 4)
               for i in (1, 2, 3, 4)},
            "output_conv1": convert_conv(sd, f"{s}.output_conv1"),
        },
    }
    if not feature_only:
        # torch: Sequential(Conv2d, ReLU, Conv2d), indices 0 and 2
        p["scratch"]["output_conv2"] = {"conv1": convert_conv(sd, f"{s}.output_conv2.0"),
                                        "conv2": convert_conv(sd, f"{s}.output_conv2.2")}
    return p


def convert_torch_mha(sd: StateDict, prefix: str):
    """torch ``nn.MultiheadAttention`` -> fused-qkv attention params: the
    packed ``in_proj_weight`` (3C, C) / ``in_proj_bias`` become one qkv."""
    p = {"qkv": {"w": _tensor(sd[f"{prefix}.in_proj_weight"]).T.contiguous()},
         "proj": convert_linear(sd, f"{prefix}.out_proj")}
    if f"{prefix}.in_proj_bias" in sd:
        p["qkv"]["b"] = _get(sd, f"{prefix}.in_proj_bias")
    return p


def _convert_track_attn_block(sd: StateDict, prefix: str, cross: bool,
                              norm_affine: bool = True):
    p = {
        "attn": convert_torch_mha(sd, f"{prefix}.cross_attn" if cross else f"{prefix}.attn"),
        "mlp": {"fc1": convert_linear(sd, f"{prefix}.mlp.fc1"),
                "fc2": convert_linear(sd, f"{prefix}.mlp.fc2")},
        # affine-free block norms (the VGGSfM variant) carry no params
        "norm1": convert_ln(sd, f"{prefix}.norm1") if norm_affine else {},
        "norm2": convert_ln(sd, f"{prefix}.norm2") if norm_affine else {},
    }
    if cross:
        p["norm_context"] = convert_ln(sd, f"{prefix}.norm_context")
    return p


def convert_updateformer(sd: StateDict, prefix: str, time_depth: int, space_depth: int,
                         use_norms: bool = True, block_norm_affine: bool = True):
    """``use_norms`` / ``block_norm_affine``: True for the track head's
    variant, False for the VGGSfM dependency's (no input / output norms,
    affine-free block norms)."""
    def blocks(name, n, cross):
        return [_convert_track_attn_block(sd, f"{prefix}.{name}.{i}", cross,
                                          block_norm_affine) for i in range(n)]

    p = {
        "input_transform": convert_linear(sd, f"{prefix}.input_transform"),
        "flow_head": convert_linear(sd, f"{prefix}.flow_head"),
        "time_blocks": blocks("time_blocks", time_depth, False),
    }
    if use_norms:
        p["input_norm"] = convert_ln(sd, f"{prefix}.input_norm")
        p["output_norm"] = convert_ln(sd, f"{prefix}.output_norm")
    if space_depth:
        # (sic) the reference parameter is named "virual_tracks"
        p["virtual_tracks"] = _get(sd, f"{prefix}.virual_tracks")
        p["space_virtual_blocks"] = blocks("space_virtual_blocks", space_depth, False)
        p["space_point2virtual_blocks"] = blocks("space_point2virtual_blocks",
                                                 space_depth, True)
        p["space_virtual2point_blocks"] = blocks("space_virtual2point_blocks",
                                                 space_depth, True)
    return p


def convert_track_head(sd: StateDict, prefix: str, depth: int = 6, predict_conf=True):
    """The reference ``TrackHead`` -> ``heads/track.py:init_track_head``'s tree."""
    pfx = f"{prefix}." if prefix else ""
    t = f"{pfx}tracker"
    p = {
        "feature_extractor": convert_dpt_head(sd, f"{pfx}feature_extractor",
                                              feature_only=True),
        "corr_mlp": {"fc1": convert_linear(sd, f"{t}.corr_mlp.fc1"),
                     "fc2": convert_linear(sd, f"{t}.corr_mlp.fc2")},
        "query_ref_token": _get(sd, f"{t}.query_ref_token"),
        "updateformer": convert_updateformer(sd, f"{t}.updateformer", depth, depth),
        "fmap_norm": convert_ln(sd, f"{t}.fmap_norm"),
        "ffeat_norm": convert_ln(sd, f"{t}.ffeat_norm"),
        # torch: Sequential(Linear, GELU), index 0 is the Linear
        "ffeat_updater": convert_linear(sd, f"{t}.ffeat_updater.0"),
        "vis_predictor": convert_linear(sd, f"{t}.vis_predictor.0"),
    }
    if predict_conf:
        p["conf_predictor"] = convert_linear(sd, f"{t}.conf_predictor.0")
    return p


def convert_sailrecon(sd: StateDict, depth: int = 24, vit_depth: int = 24):
    """A whole reference SailRecon state dict -> the port's params (the
    heads that the dict carries)."""
    p = {"aggregator": convert_aggregator(sd, "aggregator", depth, vit_depth)}
    for head, fn in (("camera_head", convert_camera_head), ("point_head", convert_dpt_head),
                     ("depth_head", convert_dpt_head)):
        if any(k.startswith(f"{head}.") for k in sd):
            p[head] = fn(sd, head)
    return p


# -- DINOv2 ViT -------------------------------------------------------------


def convert_vit(sd: StateDict, prefix: str, depth: int):
    """A DinoVisionTransformer subtree (e.g. ``aggregator.patch_embed``);
    ``register_tokens`` is None when the dict has none."""
    pfx = f"{prefix}." if prefix else ""
    return {
        "patch_embed": {"proj": convert_conv(sd, f"{pfx}patch_embed.proj")},
        "cls_token": _get(sd, f"{pfx}cls_token"),
        "pos_embed": _get(sd, f"{pfx}pos_embed"),
        "register_tokens": (_get(sd, f"{pfx}register_tokens")
                            if f"{pfx}register_tokens" in sd else None),
        "blocks": convert_blocks(sd, f"{pfx}blocks", depth, qk_norm=False),
        "norm": convert_ln(sd, f"{pfx}norm"),
    }


# -- VGGSfM standalone tracker (vggsfm_v2_tracker.pt) ------------------------


def convert_vggsfm_residual_block(sd: StateDict, prefix: str):
    """Instance norms carry no params; ``downsample`` = Sequential(Conv2d,
    norm) -> ``.downsample.0``."""
    p = {"conv1": convert_conv(sd, f"{prefix}.conv1"),
         "conv2": convert_conv(sd, f"{prefix}.conv2")}
    if f"{prefix}.downsample.0.weight" in sd:
        p["downsample"] = convert_conv(sd, f"{prefix}.downsample.0")
    return p


def convert_basic_encoder(sd: StateDict, prefix: str):
    """The stride-4 CNN."""
    return {
        "conv1": convert_conv(sd, f"{prefix}.conv1"),
        **{f"layer{i}": [convert_vggsfm_residual_block(sd, f"{prefix}.layer{i}.{j}")
                         for j in (0, 1)] for i in (1, 2, 3, 4)},
        "conv2": convert_conv(sd, f"{prefix}.conv2"),
        "conv3": convert_conv(sd, f"{prefix}.conv3"),
    }


def convert_shallow_encoder(sd: StateDict, prefix: str):
    """The stride-1 patch CNN."""
    return {
        "conv1": convert_conv(sd, f"{prefix}.conv1"),
        "layer1": convert_vggsfm_residual_block(sd, f"{prefix}.layer1"),
        "layer2": convert_vggsfm_residual_block(sd, f"{prefix}.layer2"),
        "conv2": convert_conv(sd, f"{prefix}.conv2"),
    }


def convert_vggsfm_predictor(sd: StateDict, prefix: str, depth: int, use_spaceatt: bool,
                             fine: bool):
    """The dependency-variant updateformer, the GroupNorm(1, C) feature norm
    (a LayerNorm over C on (M, C) rows: its weights map 1:1), the
    ``ffeat_updater`` Sequential, and a ``vis_predictor`` on the coarse
    predictor only."""
    p = {
        "updateformer": convert_updateformer(
            sd, f"{prefix}.updateformer", time_depth=depth,
            space_depth=depth if use_spaceatt else 0, use_norms=False,
            block_norm_affine=False),
        "norm": convert_ln(sd, f"{prefix}.norm"),
        "ffeat_updater": convert_linear(sd, f"{prefix}.ffeat_updater.0"),
    }
    if not fine:
        p["vis_predictor"] = convert_linear(sd, f"{prefix}.vis_predictor.0")
    return p


def convert_vggsfm_tracker(sd: StateDict, cfg=None):
    """A whole ``TrackerPredictor`` checkpoint -> the tree that
    ``pipeline/vggsfm_tracker.py:init_vggsfm_tracker`` makes."""
    from ..pipeline.vggsfm_tracker import VGGSfMTrackerConfig

    cfg = cfg or VGGSfMTrackerConfig()
    return {
        "coarse_fnet": convert_basic_encoder(sd, "coarse_fnet"),
        "coarse_predictor": convert_vggsfm_predictor(
            sd, "coarse_predictor", cfg.coarse.depth, cfg.coarse.use_spaceatt,
            cfg.coarse.fine),
        "fine_fnet": convert_shallow_encoder(sd, "fine_fnet"),
        "fine_predictor": convert_vggsfm_predictor(
            sd, "fine_predictor", cfg.fine.depth, cfg.fine.use_spaceatt, cfg.fine.fine),
    }
