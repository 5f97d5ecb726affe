"""Alternating-attention aggregator: joint forward and two-phase serving.

Port of ``self_supervise_sfm_tpu/models/aggregator.py``: ``aggregator_forward``,
the scene-cache build (``aggregator_build_cache``, one-shot or anchor-chunked),
``aggregator_reloc`` against the cache, and the host-staged variants of both.
Per layer of the joint forward, with anchors first:

1. frame attention, every frame over its own P tokens;
2. scene-token subsampling: per anchor the 5 special tokens plus ``rank``
   patch tokens;
3. reloc attention: query frames attend [compressed anchors ‖ own frame]
   (frame-major, the K2 kernel);
4. global attention over all anchor tokens.

Per-layer block params live in lists and a Python loop replaces the
``lax.scan``; tapped layers emit fp32 [frame ‖ reloc] query features and the
last layer the anchor camera tokens.

Two-phase serving splits that layer: the build runs steps 1, 2 and 4 over the
anchors and stores step 3's context K/V per layer; reloc runs steps 1 and 3
over query frames against the stored K/V. The scene cache is one tensor
``{"kv": (depth, B, heads, A * (rank + 5), 2 * head_dim)}`` in the compute
dtype, each row [k ‖ v] (the JAX package's "kv2" layout, so caches pass
between the two packages; its "heads" / "packed" layouts and the scanned
reloc are TPU-tiling and XLA-loop devices and have no counterpart here). The
reloc attention kernel reads a layer of it in place.

Under a mesh (``parallel/sp_block.py:scene_shard``) the joint forward, the
build and reloc run on rank-local tensors: each rank holds the frames of
its scenes (cut over ``data``) that fall in its slice of the anchors and of
the queries (cut over ``context``). The frame and reloc blocks run on them
with no collective; the compressed scene tokens are gathered over
``context`` (small: A·(rank + 5) a scene); the global block rides the ring
over the rank's anchors, which are its chunk of the A·P token axis. The
scene cache stays context-sharded, each rank storing the K/V rows of its
anchors, ``(depth, B/nd, heads, A·(rank + 5)/nc, 2·head_dim)``; reloc
gathers one layer of it at a time before the in-place kernel reads it.

With a ``model`` extent above 1 (tensor parallelism) every block (the ViT's,
frame, reloc and global) runs Megatron's body on model-local parameters
(``parallel/sp_block.py``): LN+QKV(+RoPE) on the rank's head shard, K1, K2,
the ring or the in-place kv2 kernel on its Hl heads, the row-parallel tail
summed over ``model``. The cache is then cut over heads too: each model
rank builds the rows of its heads from its head shard of the reloc block's
qkv, ``(depth, B/nd, H/nm, A·(rank + 5)/nc, 2·head_dim)``, marked
``cache["shards"] = (nd, nc, nm)``, and reloc's in-place kernel reads the
rank's heads; a whole cache is cut by heads (and scenes) one layer at a time
in reloc. The patch embedding, tokens and heads run replicated on every
model rank.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..layers import rope as R
from ..layers.attention import attention_heads_out
from ..layers.block import (
    BlockConfig, block, block_context_kv, init_block, local_attn_cfg, remat_call,
)
from ..layers.vit import ViTConfig, init_vit, vit_forward, vit_large
from ..ops.flash_attention import packed_ctx_attention
from ..parallel import sp_block as SP
from ..parallel.sharding import (
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, activate_mesh, active_mesh, gather,
)
from ..parallel.sp_block import SceneShard, global_block_ring_local

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
    # checkpoint each layer of the joint forward (recomputed in the backward)
    remat: bool = False

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


def block_cfgs(cfg: AggregatorConfig) -> Tuple[BlockConfig, ...]:
    """The configs of every block the aggregator runs (ViT, frame, reloc,
    global): tensor parallelism takes the model when each divides the model
    extent (``parallel/sp_block.py:tp_engaged``)."""
    return (cfg.vit.block_cfg, cfg.block_cfg, cfg.global_block_cfg)


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


def _embed_frames(p, cfg: AggregatorConfig, images: torch.Tensor, is_query,
                  duplicated: bool = False, frame_chunk: Optional[int] = None,
                  anchor0: bool = True, shard: Optional[SceneShard] = None):
    """images (B, S, H, W, 3) -> tokens (B, S, P, C), P = patches + specials.

    ``is_query``: S booleans. Query frames get the reloc camera/register
    tokens; of the others, frame 0 gets token index 0 (when ``anchor0``:
    it is the scene's first frame, not a later rank's first anchor) and the
    rest index 1.
    With ``duplicated`` (frames [a_0..a_{n-1}, q_0..q_{n-1}], q_i the same
    image as a_i) the ViT runs once per unique image. With ``frame_chunk``
    (dividing the unique frame count) the ViT runs per chunk of frames,
    normalisation inside the loop, so its transients are one chunk's. Under
    a ``shard`` with ``tp`` the ViT's blocks run Megatron's body on
    model-local params.
    """
    B, S, H, W, _ = images.shape
    isq = torch.as_tensor(list(is_query), dtype=torch.bool, device=images.device)
    if isq.shape != (S,):
        raise ValueError(f"is_query has {isq.numel()} entries for {S} frames")
    if duplicated:
        if S % 2:
            raise ValueError("the duplicated layout needs an even frame count")
        images = images[:, : S // 2]
    Su = images.shape[1]
    C = cfg.embed_dim
    tp_mesh = shard.tp_mesh if shard is not None else None

    def vit_tokens(imgs):
        n = imgs.shape[1]
        x = _normalize_images(imgs).reshape(B * n, H, W, 3)
        pt = vit_forward(p["vit"], x, cfg.vit, cfg.dtype, tp_mesh)["x_norm_patchtokens"]
        return pt.reshape(B, n, pt.shape[1], C)

    if frame_chunk is not None and 0 < frame_chunk < Su and Su % frame_chunk == 0:
        G = frame_chunk
        patch_tokens = None
        for a0 in range(0, Su, G):
            pt = vit_tokens(images[:, a0: a0 + G])
            if patch_tokens is None:
                patch_tokens = pt.new_empty((B, Su, pt.shape[2], C))
            patch_tokens[:, a0: a0 + G] = pt
    else:
        patch_tokens = vit_tokens(images)
    P0 = patch_tokens.shape[2]
    if duplicated:
        patch_tokens = torch.cat([patch_tokens, patch_tokens], dim=1)

    reg = cfg.num_register_tokens
    ct, rt = p["camera_token"][0], p["register_token"][0]  # (2, 1, C), (2, reg, C)
    # as if all frames were anchors, then the query frames' rows replaced
    f0 = 0 if anchor0 else 1
    cam_anchor = torch.cat([ct[f0:f0 + 1], ct[1:2].expand(max(S - 1, 0), 1, C)], dim=0)
    reg_anchor = torch.cat([rt[f0:f0 + 1], rt[1:2].expand(max(S - 1, 0), reg, C)], dim=0)
    cam_reloc = p["camera_token_reloc"][0, 0].expand(S, 1, C)
    reg_reloc = p["register_token_reloc"][0, 0].expand(S, reg, C)
    sel = isq[:, None, None]
    special = torch.cat(
        [torch.where(sel, cam_reloc, cam_anchor),
         torch.where(sel, reg_reloc, reg_anchor)],
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


def _check_taps(cfg: AggregatorConfig):
    taps_list = tuple(cfg.intermediate_layer_idx)
    if taps_list != tuple(sorted(taps_list)) or taps_list[-1] != cfg.depth - 1:
        raise ValueError("taps must be sorted and the last layer must be a tap")
    return taps_list


def _local_context(shard: Optional[SceneShard]):
    """The sharded path runs on rank-local tensors with the mesh switched
    off (as a ``shard_map`` body), so that nothing inside cuts them again
    (under tensor parallelism the blocks get the mesh of their ``model``
    group explicitly, ``SceneShard.tp_mesh``)."""
    return activate_mesh(None) if shard is not None else contextlib.nullcontext()


def _global_block(gp, x, cfg: BlockConfig, t_global, shard: Optional[SceneShard]):
    """The global block over all anchor tokens, or, under a shard, the ring
    over this rank's chunk of them (``t_global`` is then the chunk's
    tables)."""
    if shard is None:
        return block(gp, x, cfg, t_global)
    return global_block_ring_local(gp, x, cfg, t_global, shard.mesh, shard.tp_mesh)


def aggregator_forward(
    p, cfg: AggregatorConfig, images: torch.Tensor, num_anchor: int, num_query: int,
    rank: int, generator: Optional[torch.Generator] = None,
    subsample_indices: Optional[torch.Tensor] = None,
    images_duplicated: bool = False, shard: Optional[SceneShard] = None,
):
    """Joint anchors+queries forward.

    images: (B, S, H, W, 3) in [0, 1], anchors first, S = A + Q.
    Returns (taps, patch_start_idx, cam_token_last_layer): taps maps each
    layer of ``cfg.intermediate_layer_idx`` (and -1 = last) to fp32
    (B, Q, P, 2C) [frame ‖ reloc] features; cam tokens are fp32 (B, A, 2C).

    Under a ``shard`` the images are whole on every rank, which runs its
    scenes' slice of the anchors and of the queries; the taps are then the
    rank's (B/nd, Q/nc, P, 2C) and the cam tokens those of every anchor of
    its scenes, (B/nd, A, 2C).
    """
    B, S, H, W, _ = images.shape
    A, Q = num_anchor, num_query
    if S != A + Q or Q < 1:
        raise ValueError(f"frames {S} != anchors {A} + queries {Q} (Q >= 1)")
    if images_duplicated and A != Q:
        raise ValueError("the duplicated layout requires anchors == queries")
    dev = images.device
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    P0 = gh * gw
    rank = min(rank, P0)
    idx = _make_indices(cfg, generator, subsample_indices, B, A, P0, rank, dev)
    idx_own, anchor0 = idx, True
    if shard is not None:
        p = shard.aggregator_params(p)
        images = shard.scenes(images)
        images = torch.cat([shard.frames(images[:, :A], 1), shard.frames(images[:, A:], 1)],
                           dim=1)
        idx = shard.scenes(idx, 1)
        idx_own, anchor0 = shard.frames(idx, 2), shard.context_index == 0
    Bl, Sl = images.shape[:2]
    Al, Ql = idx_own.shape[2], Sl - idx_own.shape[2]
    C = cfg.embed_dim
    Ptok = P0 + cfg.patch_start_idx
    R5 = rank + cfg.patch_start_idx
    t_frame = _rope_tables_frame(cfg, gh, gw, dev)
    # the rank's chunk of the global tables is that of its own anchors
    t_global = _tile_tables(t_frame, Al)
    bcfg, bcfg_g = cfg.block_cfg, cfg.global_block_cfg
    taps_list = _check_taps(cfg)
    tpm = shard.tp_mesh if shard is not None else None

    def layer(tokens, fp, gp, rp, idx_l, idx_own_l):
        # 1. frame attention
        t = SP.block_local(fp, tokens.reshape(Bl * Sl, Ptok, C), bcfg, t_frame, tpm)
        frame_out = t.reshape(Bl, Sl, Ptok, C)
        anchors, queries = frame_out[:, :Al], frame_out[:, Al:]
        # 2. compressed scene representation (of every anchor of the scene)
        down, down_rope = _scene_tokens(anchors, idx_own_l, t_frame)
        if shard is not None:
            down = shard.gather_frames(down, 1)
            down_rope = tuple(tab[idx_l].reshape(Bl, A * R5, -1) for tab in t_frame)
        # 3. reloc attention, frame-major queries against the shared context
        q = SP.block_with_context_local(rp, queries.reshape(Bl * Ql, Ptok, C), down, bcfg,
                                        t_frame, down_rope, tpm)
        reloc_out = q.reshape(Bl, Ql, Ptok, C)
        # 4. global attention over all anchor tokens
        g = _global_block(gp, anchors.reshape(Bl, Al * Ptok, C), bcfg_g, t_global, shard)
        return frame_out, reloc_out, g.reshape(Bl, Al, Ptok, C)

    taps: Dict[int, torch.Tensor] = {}
    cam = None
    with _local_context(shard):
        tokens, _ = _embed_frames(p, cfg, images, [False] * Al + [True] * Ql,
                                  images_duplicated, anchor0=anchor0, shard=shard)
        for li in range(cfg.depth):
            fp, gp, rp = (p[k][li] for k in ("frame_blocks", "global_blocks",
                                             "reloc_blocks"))
            frame_out, reloc_out, global_out = remat_call(
                cfg.remat, layer, tokens, fp, gp, rp, idx[li], idx_own[li])
            if li in taps_list:
                taps[li] = torch.cat([frame_out[:, Al:], reloc_out], dim=-1).float()
            if li == cfg.depth - 1:
                cam = torch.cat([frame_out[:, :Al, 0], global_out[:, :, 0]], dim=-1).float()
            tokens = torch.cat([global_out, reloc_out], dim=1)
        if shard is not None:
            cam = shard.gather_frames(cam, 1)

    taps[-1] = taps[taps_list[-1]]
    return taps, cfg.patch_start_idx, cam


# -- scene-cache build + relocalisation (two-phase serving) -------------------


def _scene_tokens(frame_out, idx_l, t_frame):
    """The compressed scene tokens of some anchors and their rope tables:
    per anchor the rows ``idx_l`` of its frame-block output."""
    B, G, _, C = frame_out.shape
    R5 = idx_l.shape[-1]
    gidx = idx_l[..., None].expand(B, G, R5, C)
    down = torch.gather(frame_out, 2, gidx).reshape(B, G * R5, C)
    down_rope = tuple(tab[idx_l].reshape(B, G * R5, -1) for tab in t_frame)
    return down, down_rope


def _store_kv(kv_out, kv, n0: int = 0):
    """Write (k, v) heads (B, H, n, d) as rows [k ‖ v] of ``kv_out`` (B, H, N,
    2d) from row ``n0``."""
    k, v = kv
    n, d = k.shape[2], k.shape[3]
    kv_out[:, :, n0: n0 + n, :d] = k
    kv_out[:, :, n0: n0 + n, d:] = v


def _build_layer(cfg: AggregatorConfig, fp, gp, rp, tokens, idx_l, t_frame,
                 t_global, kv_out, shard: Optional[SceneShard] = None):
    """One build layer over all anchors at once (under a shard, the rank's):
    frame block, the reloc block's K/V of the scene tokens into ``kv_out``,
    global block (the ring under a shard). Returns (global_out, frame_out)."""
    B, A, Ptok, C = tokens.shape
    tpm = shard.tp_mesh if shard is not None else None
    t = SP.block_local(fp, tokens.reshape(B * A, Ptok, C), cfg.block_cfg, t_frame, tpm)
    frame_out = t.reshape(B, A, Ptok, C)
    down, down_rope = _scene_tokens(frame_out, idx_l, t_frame)
    _store_kv(kv_out, block_context_kv(rp, down, cfg.block_cfg, down_rope))
    g = _global_block(gp, frame_out.reshape(B, A * Ptok, C), cfg.global_block_cfg,
                      t_global, shard)
    return g.reshape(B, A, Ptok, C), frame_out


def _build_layer_chunked(cfg: AggregatorConfig, fp, gp, rp, tokens, idx_l,
                         t_frame, kv_out, anchor_chunk: int,
                         shard: Optional[SceneShard] = None):
    """One build layer with the anchor axis processed in chunks of
    ``anchor_chunk`` frames: transients scale with the chunk, resident state
    with the scene.

    Only the global attention's K/V needs every anchor token; the rest is
    per frame (frame block, scene-token K/V) or per token (global QKV
    projection, out-proj + MLP). Pass 1, per chunk: frame block into the
    ``frame_out`` buffer, the reloc block's K/V into ``kv_out``, the global
    block's k / v into full-length buffers (q is not kept). Pass 2, per
    chunk: q recomputed by the same projection on the same input, attention
    against the full k / v (per-row math does not depend on how the q axis
    is cut), then out-proj + MLP into the ``global_out`` buffer.

    Under a shard the chunks cut the rank's anchors, and pass 2 attends the
    k / v of every anchor, gathered over ``context`` once a layer (where the
    unchunked layer rides the ring).
    """
    B, A, Ptok, C = tokens.shape
    G = anchor_chunk
    bcfg, bcfg_g = cfg.block_cfg, cfg.global_block_cfg
    tpm = shard.tp_mesh if shard is not None else None
    t_global_G = _tile_tables(t_frame, G)
    R5 = idx_l.shape[-1]
    fo_buf = torch.empty_like(tokens)
    k_buf = v_buf = None
    for a0 in range(0, A, G):
        t = SP.block_local(fp, tokens[:, a0: a0 + G].reshape(B * G, Ptok, C), bcfg, t_frame,
                           tpm)
        fo = t.reshape(B, G, Ptok, C)
        fo_buf[:, a0: a0 + G] = fo
        down, down_rope = _scene_tokens(fo, idx_l[:, a0: a0 + G], t_frame)
        _store_kv(kv_out, block_context_kv(rp, down, bcfg, down_rope), a0 * R5)
        _, kc, vc = SP.qkv_local(gp, fo.reshape(B, G * Ptok, C), bcfg_g, t_global_G, tpm)
        if k_buf is None:
            shape = (B, kc.shape[1], A * Ptok, cfg.head_dim)
            k_buf, v_buf = kc.new_empty(shape), vc.new_empty(shape)
        k_buf[:, :, a0 * Ptok: (a0 + G) * Ptok] = kc
        v_buf[:, :, a0 * Ptok: (a0 + G) * Ptok] = vc
    if shard is not None:
        k_buf, v_buf = (shard.gather_frames(t, 2) for t in (k_buf, v_buf))
    go_buf = torch.empty_like(tokens)
    for a0 in range(0, A, G):
        xc = fo_buf[:, a0: a0 + G].reshape(B, G * Ptok, C)
        qc, _, _ = SP.qkv_local(gp, xc, bcfg_g, t_global_G, tpm)
        o = attention_heads_out(gp["attn"], qc, k_buf, v_buf, local_attn_cfg(gp, bcfg_g))
        go_buf[:, a0: a0 + G] = SP.attn_out_mlp_local(gp, o, xc, bcfg_g, tpm).reshape(
            B, G, Ptok, C)
    return go_buf, fo_buf


def _build_layers(p, cfg: AggregatorConfig, layers: range, tokens, idx, t_frame,
                  kv_out, anchor_chunk: Optional[int] = None,
                  shard: Optional[SceneShard] = None):
    """Run the build layers ``layers``; layer l's scene K/V goes to
    ``kv_out[l - layers.start]``. Shared by the one-shot build (all layers)
    and the host-staged build (one segment at a time). A chunk that does not
    divide the anchor count, or is not smaller than it, runs the unchunked
    layer. Returns (tokens', frame cam tokens, global cam tokens) of the last
    layer run."""
    A = tokens.shape[1]
    chunked = (anchor_chunk is not None and 0 < anchor_chunk < A
               and A % anchor_chunk == 0)
    t_global = None if chunked else _tile_tables(t_frame, A)
    frame_out = None
    for li in layers:
        fp, gp, rp = (p[k][li] for k in ("frame_blocks", "global_blocks", "reloc_blocks"))
        out = kv_out[li - layers.start]
        if chunked:
            tokens, frame_out = _build_layer_chunked(
                cfg, fp, gp, rp, tokens, idx[li], t_frame, out, anchor_chunk, shard)
        else:
            tokens, frame_out = _build_layer(
                cfg, fp, gp, rp, tokens, idx[li], t_frame, t_global, out, shard)
    return tokens, frame_out[:, :, 0], tokens[:, :, 0]


def _build_setup(p, cfg, anchor_images, rank, generator, subsample_indices,
                 anchor_chunk, chunk_embed, shard: Optional[SceneShard] = None):
    """Embed the anchors (under a shard, the rank's); (tokens, keep-indices,
    frame rope tables, cache shape of one layer)."""
    B, A, H, W, _ = anchor_images.shape
    dev = anchor_images.device
    gh, gw = H // cfg.patch_size, W // cfg.patch_size
    rank = min(rank, gh * gw)
    idx = _make_indices(cfg, generator, subsample_indices, B, A, gh * gw, rank, dev)
    anchor0 = True
    if shard is not None:
        anchor_images = shard.frames(shard.scenes(anchor_images), 1)
        idx = shard.frames(shard.scenes(idx, 1), 2)
        anchor0 = shard.context_index == 0
    B, A = anchor_images.shape[:2]
    tokens, _ = _embed_frames(
        p, cfg, anchor_images, [False] * A,
        frame_chunk=anchor_chunk if chunk_embed else None, anchor0=anchor0, shard=shard)
    t_frame = _rope_tables_frame(cfg, gh, gw, dev)
    heads = shard.heads(cfg.num_heads) if shard is not None else cfg.num_heads
    layer_shape = (B, heads, A * (rank + cfg.patch_start_idx), 2 * cfg.head_dim)
    return tokens, idx, t_frame, layer_shape


def aggregator_build_cache(
    p, cfg: AggregatorConfig, anchor_images: torch.Tensor, rank: int,
    generator: Optional[torch.Generator] = None,
    subsample_indices: Optional[torch.Tensor] = None,
    anchor_chunk: Optional[int] = None, chunk_embed: bool = True,
    shard: Optional[SceneShard] = None,
):
    """Phase 1: run the anchors, record per layer the reloc block's K/V of
    the compressed scene tokens.

    ``anchor_chunk``: build in chunks of this many anchor frames (see
    :func:`_build_layer_chunked`). ``chunk_embed``: also run the ViT per
    chunk. Returns (cache, cam_token_last_layer): ``{"kv": (depth, B, heads,
    A * (rank + 5), 2 * head_dim)}`` in the compute dtype, preallocated and
    filled layer by layer, and the fp32 (B, A, 2C) anchor camera tokens.

    Under a ``shard`` each rank builds its anchors (``anchor_chunk`` then
    cuts those) and keeps their rows of the cache, ``(depth, B/nd, heads,
    A * (rank + 5) / nc, 2 * head_dim)``, marked ``cache["shards"] = (nd,
    nc, nm)``; under tensor parallelism (nm above 1, or forced) only the
    rank's heads, H / nm. The cam tokens come back whole on every rank.
    """
    if shard is not None:
        p = shard.aggregator_params(p)
    with _local_context(shard):
        tokens, idx, t_frame, layer_shape = _build_setup(
            p, cfg, anchor_images, rank, generator, subsample_indices, anchor_chunk,
            chunk_embed, shard)
        kv = torch.empty((cfg.depth, *layer_shape), dtype=cfg.dtype, device=tokens.device)
        _, frame_cam, global_cam = _build_layers(
            p, cfg, range(cfg.depth), tokens, idx, t_frame, kv, anchor_chunk, shard)
        cam = torch.cat([frame_cam, global_cam], dim=-1).float()
        if shard is None:
            return {"kv": kv}, cam
        return {"kv": kv, "shards": _cache_shards(shard)}, shard.gather_all(cam)


def _reloc_layer_kv2(cfg: AggregatorConfig, fp, rp, tokens, ckv, layer_idx: int,
                     t_frame, shard: Optional[SceneShard] = None):
    """One reloc layer against a kv2 cache stack (the whole cache or one
    segment of it); ``layer_idx`` indexes ``ckv``'s leading dim inside the
    attention kernel. Under a ``shard`` with ``tp`` the blocks are
    Megatron's and ``ckv`` holds the rank's heads. Returns (reloc_out,
    frame_out), both (B, Q, P, C)."""
    B, Q, Ptok, C = tokens.shape
    bcfg = cfg.block_cfg
    tp_mesh = shard.tp_mesh if shard is not None else None
    t = SP.block_local(fp, tokens.reshape(B * Q, Ptok, C), bcfg, t_frame, tp_mesh)
    q, k, v = SP.qkv_local(rp, t, bcfg, t_frame, tp_mesh)
    o = packed_ctx_attention(q, k, v, ckv, layer_idx, impl=bcfg.attn.impl)
    out = SP.attn_out_mlp_local(rp, o, t, bcfg, tp_mesh)
    return out.reshape(B, Q, Ptok, C), t.reshape(B, Q, Ptok, C)


def _reloc_layers(p, cfg: AggregatorConfig, layers: range, tokens, layer_kv, t_frame,
                  taps: Dict[int, torch.Tensor], shard: Optional[SceneShard] = None):
    """Run reloc layers ``layers``, layer l against ``layer_kv(l)`` (a kv2
    stack and the layer's index in it), adding the tapped layers to
    ``taps``."""
    taps_list = tuple(cfg.intermediate_layer_idx)
    for l in layers:
        ckv, index = layer_kv(l)
        tokens, frame_out = _reloc_layer_kv2(
            cfg, p["frame_blocks"][l], p["reloc_blocks"][l], tokens, ckv, index, t_frame,
            shard)
        if l in taps_list:
            taps[l] = torch.cat([frame_out, tokens], dim=-1).float()
    return tokens


def _reloc_setup(p, cfg: AggregatorConfig, images: torch.Tensor,
                 shard: Optional[SceneShard] = None):
    _check_taps(cfg)
    B, Q, H, W, _ = images.shape
    tokens, _ = _embed_frames(p, cfg, images, [True] * Q, shard=shard)
    t_frame = _rope_tables_frame(cfg, H // cfg.patch_size, W // cfg.patch_size,
                                 images.device)
    return tokens, t_frame


def _cache_shards(shard: Optional[SceneShard]):
    """How a cache built under ``shard`` is cut: (data, context, model)
    extents, model 1 unless its heads are cut."""
    return (shard.nd, shard.nc, shard.nm if shard.tp else 1)


def _cache_reader(cache, shard: Optional[SceneShard]):
    """``l -> (kv2 stack, index)`` for reloc layer l. A whole cache is read
    in place. Otherwise layer l becomes a transient (1, B', heads', A·(rank
    + 5), 2·head_dim) for the rank's scenes and heads: a context-sharded
    cache gathered over ``context`` (and over ``data`` when the queries are
    not cut over it, over ``model`` when its heads are cut and the queries'
    blocks are not), a whole cache cut to the rank's scenes when the queries
    are, and to the rank's heads under tensor parallelism."""
    kv, built = cache["kv"], cache.get("shards")
    tp = shard is not None and shard.tp
    if built is None and (shard is None or (shard.nd == 1 and not tp)):
        return lambda l: (kv, l)
    mesh = shard.mesh if shard is not None else active_mesh()
    if built is not None:
        built = tuple(built)
        want = _cache_shards(shard) if shard is not None else None
        if mesh is None or (want is not None and built != want) or (
                want is None and built[:2] != (mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS])):
            raise ValueError(
                f"the cache was built over a (data, context, model) = {built} mesh; reloc "
                "it under that mesh")

    def read(l):
        layer = kv[l: l + 1]
        if built is None:
            layer = shard.scenes(layer, 1)
            if tp:
                hl = shard.heads(layer.shape[2])
                layer = layer.narrow(2, shard.mesh.index(MODEL_AXIS) * hl, hl).contiguous()
            return layer, 0
        layer = gather(layer, mesh, CONTEXT_AXIS, 3)
        if shard is None:
            layer = gather(layer, mesh, DATA_AXIS, 1)
            if built[2] > 1:
                layer = gather(layer, mesh, MODEL_AXIS, 2)
        return layer, 0

    return read


def aggregator_reloc(p, cfg: AggregatorConfig, cache, images: torch.Tensor,
                     shard: Optional[SceneShard] = None):
    """Phase 2: localise query frames (B, Q, H, W, 3) against a frozen scene
    cache; each query attends the cache and itself only. Returns (taps,
    patch_start_idx), taps as in :func:`aggregator_forward`; under a
    ``shard`` the rank's queries, (B/nd, Q/nc, P, 2C), against the cache
    whole or as :func:`aggregator_build_cache` left it under the same
    mesh."""
    if shard is not None:
        p = shard.aggregator_params(p)
        images = shard.frames(shard.scenes(images), 1)
    read = _cache_reader(cache, shard)
    with _local_context(shard):
        tokens, t_frame = _reloc_setup(p, cfg, images, shard)
        taps: Dict[int, torch.Tensor] = {}
        _reloc_layers(p, cfg, range(cfg.depth), tokens, read, t_frame, taps, shard)
    taps[-1] = taps[cfg.depth - 1]
    return taps, cfg.patch_start_idx


# -- host-staged build / reloc: the scene is bounded by host RAM --------------


def _segments(cfg: AggregatorConfig, num_segments: int):
    if num_segments < 1 or cfg.depth % num_segments:
        raise ValueError(
            f"depth {cfg.depth} must divide into {num_segments} segments")
    seg_len = cfg.depth // num_segments
    return [range(lo, lo + seg_len) for lo in range(0, cfg.depth, seg_len)]


def aggregator_build_cache_staged(
    p, cfg: AggregatorConfig, anchor_images: torch.Tensor, rank: int,
    generator: Optional[torch.Generator] = None,
    subsample_indices: Optional[torch.Tensor] = None,
    num_segments: int = 4, anchor_chunk: Optional[int] = None,
    chunk_embed: bool = True,
):
    """Host-staged phase 1: the cache streams to host RAM as it is built.

    Depth splits into ``num_segments`` contiguous layer ranges. After each,
    the segment's kv2 tensor is copied into the host cache (pinned memory
    when the build runs on a card; asynchronously, then the stream is
    synchronised before the device buffer is released), so the device holds
    the activations and one segment's cache only.

    Returns ``({"kv": CPU tensor (depth, B, H, A*R5, 2hd)}, cam token CPU
    tensor)``: tensors, not numpy arrays (numpy has no bfloat16), consumed by
    :func:`aggregator_reloc_staged` or moved to the device wholesale for
    :func:`aggregator_reloc` when they fit.
    """
    segments = _segments(cfg, num_segments)
    tokens, idx, t_frame, layer_shape = _build_setup(
        p, cfg, anchor_images, rank, generator, subsample_indices, anchor_chunk,
        chunk_embed)
    dev = tokens.device
    host = torch.empty((cfg.depth, *layer_shape), dtype=cfg.dtype,
                       pin_memory=dev.type == "cuda")
    frame_cam = global_cam = None
    for seg in segments:
        kv_seg = torch.empty((len(seg), *layer_shape), dtype=cfg.dtype, device=dev)
        tokens, frame_cam, global_cam = _build_layers(
            p, cfg, seg, tokens, idx, t_frame, kv_seg, anchor_chunk)
        host[seg.start: seg.stop].copy_(kv_seg, non_blocking=True)
        if dev.type == "cuda":  # the copy is done before the buffer is released
            torch.cuda.current_stream(dev).synchronize()
        del kv_seg
    cam = torch.cat([frame_cam, global_cam], dim=-1).float().cpu()
    return {"kv": host}, cam


def aggregator_reloc_staged(p, cfg: AggregatorConfig, host_cache,
                            images: torch.Tensor, num_segments: int = 4):
    """Phase 2 against a host-RAM cache: one layer segment is uploaded at a
    time and its layers index it by their place inside the segment, so the
    device holds the query activations and one segment's kv2 tensor."""
    segments = _segments(cfg, num_segments)
    tokens, t_frame = _reloc_setup(p, cfg, images)
    dev = tokens.device
    kv = host_cache["kv"]
    taps: Dict[int, torch.Tensor] = {}
    for seg in segments:
        kv_seg = kv[seg.start: seg.stop].to(dev, non_blocking=True)
        tokens = _reloc_layers(p, cfg, seg, tokens,
                               lambda l, s=seg.start: (kv_seg, l - s), t_frame, taps)
        del kv_seg  # released in stream order, after the segment's readers
    taps[-1] = taps[cfg.depth - 1]
    return taps, cfg.patch_start_idx
