"""Alternating-attention aggregator, joint forward.

Port of ``self_supervise_sfm_tpu/models/aggregator.py`` (``aggregator_forward``
and its helpers; the scene-cache build and reloc paths are later slices).
Per layer, with anchors first:

1. frame attention, every frame over its own P tokens;
2. scene-token subsampling: per anchor the 5 special tokens plus ``rank``
   patch tokens;
3. reloc attention: query frames attend [compressed anchors ‖ own frame]
   (frame-major, the K2 kernel);
4. global attention over all anchor tokens.

Per-layer block params live in lists and a Python loop replaces the
``lax.scan``; tapped layers emit fp32 [frame ‖ reloc] query features and the
last layer the anchor camera tokens.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..layers import rope as R
from ..layers.block import BlockConfig, block, block_with_context, init_block
from ..layers.vit import ViTConfig, init_vit, vit_forward, vit_large

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AggregatorConfig:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_freq: float = 100.0
    init_values: float = 0.01
    intermediate_layer_idx: Tuple[int, ...] = (4, 11, 17, 23)
    vit: ViTConfig = field(default_factory=vit_large)
    compute_dtype: str = "float32"  # trunk dtype; taps are returned in fp32
    attn_impl: str = "auto"
    global_attn_impl: str = "auto"
    fused_qkv: str = "auto"
    fused_mlp: str = "auto"

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    def _block_cfg(self, impl: str) -> BlockConfig:
        return BlockConfig(
            dim=self.embed_dim, num_heads=self.num_heads, mlp_ratio=self.mlp_ratio,
            qk_norm=self.qk_norm, ln_eps=1e-5, init_values=self.init_values,
            attn_impl=impl, fused_qkv=self.fused_qkv, fused_mlp=self.fused_mlp,
        )

    @property
    def block_cfg(self) -> BlockConfig:
        return self._block_cfg(self.attn_impl)

    @property
    def global_block_cfg(self) -> BlockConfig:
        return self._block_cfg(self.global_attn_impl)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def init_aggregator(g, device, cfg: AggregatorConfig):
    C = cfg.embed_dim
    reg = cfg.num_register_tokens

    def blocks():
        return [init_block(g, device, cfg.block_cfg) for _ in range(cfg.depth)]

    def tok(shape):
        return 1e-6 * torch.randn(shape, generator=g, device=device)

    return {
        "vit": init_vit(g, device, cfg.vit),
        "frame_blocks": blocks(),
        "global_blocks": blocks(),
        "reloc_blocks": blocks(),
        # index 0: first frame; index 1: all other frames
        "camera_token": tok((1, 2, 1, C)),
        "register_token": tok((1, 2, reg, C)),
        "camera_token_reloc": tok((1, 1, 1, C)),
        "register_token_reloc": tok((1, 1, reg, C)),
    }


def _normalize_images(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) in [0, 1] -> resnet-normalised."""
    mean = torch.tensor(_RESNET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(_RESNET_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


def _embed_frames(p, cfg: AggregatorConfig, images: torch.Tensor, num_anchor: int,
                  duplicated: bool = False):
    """images (B, S, H, W, 3) -> tokens (B, S, P, C), P = patches + specials.

    Frames [num_anchor:] are queries and get the reloc camera/register
    tokens; anchor 0 gets token index 0, the other anchors index 1. With
    ``duplicated`` (frames [a_0..a_{n-1}, q_0..q_{n-1}], q_i the same image
    as a_i) the ViT runs once per unique image.
    """
    B, S, H, W, _ = images.shape
    if duplicated:
        if S % 2:
            raise ValueError("the duplicated layout needs an even frame count")
        images = images[:, : S // 2]
    Su = images.shape[1]
    x = _normalize_images(images).reshape(B * Su, H, W, 3)
    patch_tokens = vit_forward(p["vit"], x, cfg.vit, cfg.dtype)["x_norm_patchtokens"]
    P0 = patch_tokens.shape[1]
    C = cfg.embed_dim
    patch_tokens = patch_tokens.reshape(B, Su, P0, C)
    if duplicated:
        patch_tokens = torch.cat([patch_tokens, patch_tokens], dim=1)

    A, Q = num_anchor, S - num_anchor
    reg = cfg.num_register_tokens
    ct, rt = p["camera_token"][0], p["register_token"][0]  # (2, 1, C), (2, reg, C)
    cam_anchor = torch.cat([ct[0:1], ct[1:2].expand(max(A - 1, 0), 1, C)], dim=0)
    reg_anchor = torch.cat([rt[0:1], rt[1:2].expand(max(A - 1, 0), reg, C)], dim=0)
    cam_query = p["camera_token_reloc"][0, 0].expand(Q, 1, C)
    reg_query = p["register_token_reloc"][0, 0].expand(Q, reg, C)
    special = torch.cat(
        [torch.cat([cam_anchor, cam_query], dim=0),
         torch.cat([reg_anchor, reg_query], dim=0)],
        dim=1,
    ).to(cfg.dtype)  # (S, 5, C)
    special = special[None].expand(B, *special.shape)
    return torch.cat([special, patch_tokens], dim=2), P0


def _rope_tables_frame(cfg: AggregatorConfig, grid_h: int, grid_w: int, device):
    """(cos, sin) for one frame's [5 specials + grid] tokens, shape (P, hd)."""
    pos = R.position_grid(grid_h, grid_w, device) + 1  # specials sit at 0
    pos_special = torch.zeros((cfg.patch_start_idx, 2), device=device)
    pos = torch.cat([pos_special, pos], dim=0)
    return R.rope_tables(pos, cfg.head_dim, cfg.rope_freq)


def _tile_tables(tabs, n: int):
    cos, sin = tabs
    return cos.repeat(n, 1), sin.repeat(n, 1)


def draw_subsample_indices(cfg: AggregatorConfig, B: int, A: int, P0: int,
                           rank: int, generator: torch.Generator) -> torch.Tensor:
    """(depth, B, A, rank) patch-relative keep-indices: a random permutation
    per (layer, batch, anchor), cut to ``rank``."""
    n = cfg.depth * B * A
    keys = torch.rand((n, P0), generator=generator, device=generator.device)
    perm = keys.argsort(dim=-1)[:, :rank]
    return perm.reshape(cfg.depth, B, A, rank)


def _make_indices(cfg, generator, subsample_indices_, B, A, P0, rank, device):
    """Keep-indices into the full token axis, (depth, B, A, 5 + rank): the
    special tokens, then ``rank`` patch tokens (explicit, drawn from
    ``generator``, or all of them at full rank)."""
    rank = min(rank, P0)
    if subsample_indices_ is None:
        if generator is not None:
            subsample_indices_ = draw_subsample_indices(cfg, B, A, P0, rank, generator)
        elif rank == P0:
            # full rank keeps every patch token; outputs are invariant to
            # the permutation order
            subsample_indices_ = torch.arange(P0, device=device).expand(
                cfg.depth, B, A, P0)
        else:
            raise ValueError(
                f"a subsample generator or explicit subsample_indices is "
                f"required when rank ({rank}) < num patch tokens ({P0})"
            )
    perm = torch.as_tensor(subsample_indices_, device=device).long()
    if perm.shape[-1] != rank:
        raise ValueError(f"subsample_indices last dim {perm.shape[-1]} != rank {rank}")
    perm = perm + cfg.patch_start_idx
    specials = torch.arange(cfg.patch_start_idx, device=device).expand(
        *perm.shape[:-1], cfg.patch_start_idx)
    return torch.cat([specials, perm], dim=-1)


def aggregator_forward(
    p, cfg: AggregatorConfig, images: torch.Tensor, num_anchor: int, num_query: int,
    rank: int, generator: Optional[torch.Generator] = None,
    subsample_indices: Optional[torch.Tensor] = None,
    images_duplicated: bool = False,
):
    """Joint anchors+queries forward.

    images: (B, S, H, W, 3) in [0, 1], anchors first, S = A + Q.
    Returns (taps, patch_start_idx, cam_token_last_layer): taps maps each
    layer of ``cfg.intermediate_layer_idx`` (and -1 = last) to fp32
    (B, Q, P, 2C) [frame ‖ reloc] features; cam tokens are fp32 (B, A, 2C).
    """
    B, S, H, W, _ = images.shape
    A, Q = num_anchor, num_query
    if S != A + Q or Q < 1:
        raise ValueError(f"frames {S} != anchors {A} + queries {Q} (Q >= 1)")
    if images_duplicated and A != Q:
        raise ValueError("the duplicated layout requires anchors == queries")
    dev = images.device
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    tokens, P0 = _embed_frames(p, cfg, images, A, images_duplicated)
    C = cfg.embed_dim
    Ptok = P0 + cfg.patch_start_idx
    rank = min(rank, P0)
    R5 = rank + cfg.patch_start_idx
    idx = _make_indices(cfg, generator, subsample_indices, B, A, P0, rank, dev)

    t_frame = _rope_tables_frame(cfg, gh, gw, dev)
    t_global = _tile_tables(t_frame, A)
    bcfg, bcfg_g = cfg.block_cfg, cfg.global_block_cfg
    taps_list = tuple(cfg.intermediate_layer_idx)
    if taps_list[-1] != cfg.depth - 1:
        raise ValueError("the last layer must be an intermediate tap")

    taps: Dict[int, torch.Tensor] = {}
    cam = None
    for li in range(cfg.depth):
        fp, gp, rp = (p[k][li] for k in ("frame_blocks", "global_blocks", "reloc_blocks"))
        idx_l = idx[li]
        # 1. frame attention
        t = block(fp, tokens.reshape(B * S, Ptok, C), bcfg, t_frame)
        frame_out = t.reshape(B, S, Ptok, C)
        anchors, queries = frame_out[:, :A], frame_out[:, A:]
        # 2. compressed scene representation
        gidx = idx_l[..., None].expand(B, A, R5, C)
        down = torch.gather(anchors, 2, gidx).reshape(B, A * R5, C)
        down_rope = tuple(tab[idx_l].reshape(B, A * R5, -1) for tab in t_frame)
        # 3. reloc attention, frame-major queries against the shared context
        q = block_with_context(rp, queries.reshape(B * Q, Ptok, C), down, bcfg,
                               t_frame, down_rope)
        reloc_out = q.reshape(B, Q, Ptok, C)
        # 4. global attention over all anchor tokens
        g = block(gp, anchors.reshape(B, A * Ptok, C), bcfg_g, t_global)
        global_out = g.reshape(B, A, Ptok, C)

        if li in taps_list:
            taps[li] = torch.cat([frame_out[:, A:], reloc_out], dim=-1).float()
        if li == cfg.depth - 1:
            cam = torch.cat([frame_out[:, :A, 0], global_out[:, :, 0]], dim=-1).float()
        tokens = torch.cat([global_out, reloc_out], dim=1)

    taps[-1] = taps[taps_list[-1]]
    return taps, cfg.patch_start_idx, cam
