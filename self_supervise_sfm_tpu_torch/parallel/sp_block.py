"""Frame-, sequence- and tensor-parallel transformer blocks over the process mesh.

Port of ``self_supervise_sfm_tpu/parallel/sp_block.py``. Three variants, one
for each attention site of the aggregator:

- :func:`frame_block_sharded`: frames cut over data x context. Frame (and
  ViT) attention is per frame, so the block runs on the rank's frames with
  no collective.
- :func:`reloc_block_sharded`: query frames cut, the small compressed scene
  replicated on every rank of a scene; the fused [ctx ‖ own frame]
  attention runs on the rank's frames.
- :func:`global_block_ring`: the (A·P) token axis cut over ``context``: the
  fused LN+QKV(+RoPE) kernel on the rank's tokens with its slice of the
  RoPE tables, ring attention (``ops/ring_attention.py``; K/V never
  gathered), then the fused out-projection and MLP on the rank's tokens.

Each takes whole tensors, as JAX's take global arrays, and the plain
``block`` / ``block_with_context`` where JAX's does and under the same
conditions (no mesh, extents of 1, an axis that does not divide, frames
that would land on a rank without their scene); that is the replicated
compute JAX runs, with no collective. Otherwise it cuts the rank's shard
(``parallel/sharding.py:scatter``), runs the block on it with the mesh
switched off (as a ``shard_map`` body), the parameters under the
all-reduce rule (``replicate``), and gathers the output whole. The
aggregator's sharded path runs the same bodies on tensors that stay
rank-local from the entry point's slice to its final gather
(:class:`SceneShard`, :func:`global_block_ring_local`).

With a ``model`` extent above 1 (tensor parallelism) every variant runs
Megatron's block on the frames it would cut (JAX's ``_block_tp``,
``_block_ctx_tp`` and the ring's head split): each rank holds its head
shard of qkv (its columns of q, of k and of v) and of the out-projection's
rows, its part of fc1's columns and of fc2's rows
(:func:`tp_block_params`). The column-parallel half is LN+QKV(+RoPE) on the
head shard (the kernel takes a (C, 3 Hl 64) weight) and K1, K2 or the ring
on Hl heads; the row-parallel tail (:func:`tp_attn_partial`,
:func:`tp_attn_residual`, :func:`tp_mlp_partial`, :func:`tp_mlp_residual`)
is JAX's ``_tp_out_mlp``: the merged heads @ the proj rows summed over
``model``, the bias once, layer scale and residual; LN2, the fc1 part,
GELU, the fc2 rows summed over ``model``, bias, layer scale and residual,
in plain products (JAX's are XLA's, outside any Pallas kernel). Megatron's
two operators sit at the column-parallel inputs (``replicate`` over
``model``: identity forward, the gradient summed) and the row-parallel
outputs (``reduce_from_model``: the sum forward, identity backward). A
block whose heads or hidden width the model extent does not divide runs
the plain block, as JAX's does. The aggregator's rank-local layout decides
once for the whole model (:func:`tp_engaged`: every block divides, else
none is cut) and its blocks trust it: they see model-local parameters and
a mesh switched off, and the layout hands them the mesh of its ``model``
group explicitly (``SceneShard.tp_mesh``: a rematerialised layer's
recompute in the backward runs outside the forward's contexts); given
whole-width weights at a model extent above 1 they raise.

The port needs no mesh gate on the fused kernels (JAX's
``layers/block.py`` turns them off under a multi-device mesh, since a
``pallas_call`` is opaque to GSPMD): its blocks only ever see rank-local
shards.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from ..layers import params as Pm
from ..layers.attention import _merge_heads, attention_heads_out
from ..layers.block import (
    BlockConfig, attn_out_mlp, block, block_context_kv, block_with_context, local_attn_cfg,
    qkv_parts,
)
from ..ops.ring_attention import ring_attention_local
from .sharding import (
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, Mesh, _tp_dim, activate_mesh, active_mesh, gather,
    gather_summed, model_groups, model_part, reduce_from_model, replicate, scatter,
)

# Validation hook: with it on, the sharded paths stay engaged when every
# mesh axis has extent 1. A world of one rank then runs the exact sharded
# program each rank of a larger mesh runs (a ring of one chunk, collectives
# over groups of one): the way to run it on a machine with one card, where
# NCCL takes one rank a device. ``tp=True`` engages the Megatron blocks at a
# model extent of 1 as well.
_FORCE_SINGLE_DEVICE_SPMD = False
_FORCE_TP = False


@contextlib.contextmanager
def force_single_device_spmd(tp: bool = False):
    global _FORCE_SINGLE_DEVICE_SPMD, _FORCE_TP
    prev = _FORCE_SINGLE_DEVICE_SPMD, _FORCE_TP
    _FORCE_SINGLE_DEVICE_SPMD, _FORCE_TP = True, tp
    try:
        yield
    finally:
        _FORCE_SINGLE_DEVICE_SPMD, _FORCE_TP = prev


def _axes_over(mesh: Mesh, axes) -> Tuple[str, ...]:
    if _FORCE_SINGLE_DEVICE_SPMD:
        return tuple(a for a in axes if a in mesh.shape)
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def _extent(mesh: Mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape.get(a, 1)
    return n


def _frames_shardable(n_frames: int, mesh: Optional[Mesh], axes) -> bool:
    if mesh is None:
        return False
    n = _extent(mesh, _axes_over(mesh, axes))
    return (n > 1 or _FORCE_SINGLE_DEVICE_SPMD) and n_frames % n == 0


# -- tensor parallelism ------------------------------------------------------------


def tp_active(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` cuts over ``model``: an extent above 1, or the
    forced single-device program with ``tp``."""
    return mesh is not None and (mesh.shape.get(MODEL_AXIS, 1) > 1 or _FORCE_TP)


def tp_divides(cfg: BlockConfig, m: int) -> bool:
    """JAX's ``_tp_divides``: the heads and the MLP's hidden width split
    over ``m`` model ranks."""
    return cfg.num_heads % m == 0 and cfg.mlp_hidden % m == 0


def tp_blocks_divide(block_cfgs, m: int) -> bool:
    """Whether every block config runs Megatron's body at a model extent of
    ``m``: the heads and the hidden width of each divide it."""
    return all(tp_divides(c, m) for c in block_cfgs)


def tp_engaged(block_cfgs, mesh: Optional[Mesh]) -> bool:
    """The one decision that a model's blocks (``block_cfgs``, each block
    config it runs) are Megatron's under ``mesh``: it cuts over ``model``
    (or the single-device program forces it) and every block divides the
    model extent; else each model rank runs the whole model (JAX's
    fallback). The aggregator's layout (:class:`SceneShard` ``tp``) and the
    train state's (``loop.StateLayout.tp``) hold it; the blocks trust it."""
    return tp_active(mesh) and tp_blocks_divide(block_cfgs, mesh.shape[MODEL_AXIS])


def _tp_group(p, cfg: BlockConfig, tp_mesh: Optional[Mesh]) -> Optional[Mesh]:
    """``tp_mesh`` as the caller decided it (Megatron's body over its
    ``model`` group, or None: the plain block). Megatron's body on
    whole-width weights at a model extent above 1 would compute every head
    and the whole MLP on each rank and sum m copies over ``model``: that
    raises."""
    if tp_mesh is not None:
        m = tp_mesh.shape[MODEL_AXIS]
        cols = p["attn"]["qkv"]["w"].shape[-1]
        if not tp_divides(cfg, m) or cols != 3 * cfg.dim // m:
            raise ValueError(
                f"Megatron's block over {m} model ranks needs the rank's head shard of "
                f"qkv, (.., {3 * cfg.dim // m}) at {cfg.num_heads} heads; got {cols} "
                "columns")
    return tp_mesh


# the leaves of a block that the column-parallel half reads before the
# all-reduce (each model rank holds a part of their gradient)
_IN_BRANCH = ("norm1", "norm2", "q_norm", "k_norm")


def tp_in_branch(path) -> bool:
    """Whether a block leaf at ``path`` (its dict keys from the block down)
    is read inside a column-parallel branch: LN1, the qk-norms and LN2. Each
    model rank holds a part of its gradient, which is summed over
    ``model``; the proj and fc2 biases and the layer scales sit after the
    all-reduce, so every rank holds their whole gradient already."""
    return any(k in _IN_BRANCH for k in path if isinstance(k, str))


def tp_block_params(p, m: int, i: int):
    """Model rank ``i``'s part of a whole block's parameters ``p`` at a model
    extent ``m``: qkv's columns of q, of k and of v for heads ``[i Hl, (i+1)
    Hl)`` (JAX's ``_tp_local_attn``), the proj rows of those heads, fc1's
    columns and bias and fc2's rows for hidden units ``[i Ch/m, (i+1)
    Ch/m)``; the rest whole. Slices of ``p`` (differentiable)."""

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        d = _tp_dim(path)
        return node if d is None else model_part(node, d, m, i, model_groups(path))

    return walk(p, ())


def tp_replicated_params(p, mesh: Mesh, frame_axes):
    """A whole block's parameters, used on this rank's frames (cut over
    ``frame_axes``) through Megatron's body: this rank's part of each
    (:func:`tp_block_params`), under the gradient rule that makes each
    whole leaf's gradient the true one on every rank. A leaf that is cut
    or read inside a branch holds a part of its gradient on each model
    rank: summed over ``model`` and the frame axes; the others over the
    frame axes."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return _tp_leaf(node, path, mesh, frame_axes)

    return walk(p, ())


def _tp_leaf(node, path, mesh: Mesh, frame_axes):
    """:func:`tp_replicated_params`'s rule for one leaf at ``path`` (its keys
    from the block down)."""
    d = _tp_dim(path)
    if torch.is_grad_enabled():
        if frame_axes:
            node = replicate(node, mesh, frame_axes)
        if d is not None or tp_in_branch(path):
            node = replicate(node, mesh, MODEL_AXIS)
    if d is None:
        return node
    return model_part(node, d, mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS),
                      model_groups(path))


def tp_attn_partial(p, o):
    """Rank's part of the out-projection: its heads' merged output (B, N,
    Hl d) @ its proj rows (Hl d, C)."""
    merged = _merge_heads(o)
    return merged @ p["attn"]["proj"]["w"].to(merged.dtype)


def tp_attn_residual(p, x, y):
    """x + ls1 * (y + proj bias), y the proj product summed over ``model``."""
    if "b" in p["attn"]["proj"]:
        y = y + p["attn"]["proj"]["b"].to(y.dtype)
    return x + Pm.layer_scale(p["ls1"], y)


def tp_mlp_partial(p, x, cfg: BlockConfig):
    """Rank's part of the MLP: GELU(LN2(x) @ its fc1 columns + bias) @ its fc2
    rows."""
    h = Pm.layer_norm(p["norm2"], x, cfg.ln_eps)
    h = Pm.gelu(Pm.linear(p["mlp"]["fc1"], h))
    return h @ p["mlp"]["fc2"]["w"].to(h.dtype)


def tp_mlp_residual(p, x, y2):
    """x + ls2 * (y2 + fc2 bias), y2 the fc2 product summed over ``model``."""
    if "b" in p["mlp"]["fc2"]:
        y2 = y2 + p["mlp"]["fc2"]["b"].to(y2.dtype)
    return x + Pm.layer_scale(p["ls2"], y2)


def tp_out_mlp(p, o, x, cfg: BlockConfig, mesh: Mesh):
    """The row-parallel tail of Megatron's block (JAX's ``_tp_out_mlp``) on
    the rank's head outputs ``o`` (B, Hl, N, d) and the block input ``x``."""
    x = tp_attn_residual(p, x, reduce_from_model(tp_attn_partial(p, o), mesh))
    y2 = tp_mlp_partial(p, replicate(x, mesh, MODEL_AXIS), cfg)
    return tp_mlp_residual(p, x, reduce_from_model(y2, mesh))


def tp_qkv(p, x, cfg: BlockConfig, rope_cos_sin, mesh: Mesh):
    """The column-parallel half's q, k, v (B, Hl, N, d) of the rank's heads:
    LN+QKV(+RoPE) of the whole-width ``x`` on the head-shard weight."""
    return qkv_parts(p, replicate(x, mesh, MODEL_AXIS), cfg, rope_cos_sin)


def block_local(p, x, cfg: BlockConfig, rope_cos_sin=None, tp_mesh: Optional[Mesh] = None):
    """``block`` on rank-local tensors; Megatron's block over ``tp_mesh``'s
    model group (model-local ``p``) when given."""
    mesh = _tp_group(p, cfg, tp_mesh)
    if mesh is None:
        return block(p, x, cfg, rope_cos_sin)
    q, k, v = tp_qkv(p, x, cfg, rope_cos_sin, mesh)
    o = attention_heads_out(p["attn"], q, k, v, local_attn_cfg(p, cfg))
    return tp_out_mlp(p, o, x, cfg, mesh)


def block_with_context_local(p, x, context, cfg: BlockConfig, rope_q=None, rope_ctx=None,
                             tp_mesh: Optional[Mesh] = None):
    """``block_with_context`` on rank-local tensors; Megatron's over
    ``tp_mesh`` as :func:`block_local`: the context's K/V of the rank's
    heads (JAX's ``kv_heads`` on the head-sliced weight), the [ctx ‖ own
    frame] attention on them."""
    mesh = _tp_group(p, cfg, tp_mesh)
    if mesh is None:
        return block_with_context(p, x, context, cfg, rope_q, rope_ctx)
    ekv = block_context_kv(p, replicate(context, mesh, MODEL_AXIS), cfg, rope_ctx)
    q, k, v = tp_qkv(p, x, cfg, rope_q, mesh)
    o = attention_heads_out(p["attn"], q, k, v, local_attn_cfg(p, cfg), extra_kv=ekv)
    return tp_out_mlp(p, o, x, cfg, mesh)


def qkv_local(p, x, cfg: BlockConfig, rope_cos_sin=None, tp_mesh: Optional[Mesh] = None):
    """``qkv_parts`` on rank-local tensors; the column-parallel half over
    ``tp_mesh`` as :func:`block_local`."""
    mesh = _tp_group(p, cfg, tp_mesh)
    if mesh is None:
        return qkv_parts(p, x, cfg, rope_cos_sin)
    return tp_qkv(p, x, cfg, rope_cos_sin, mesh)


def attn_out_mlp_local(p, o, x, cfg: BlockConfig, tp_mesh: Optional[Mesh] = None):
    """``attn_out_mlp`` on rank-local tensors; the row-parallel tail over
    ``tp_mesh`` as :func:`block_local`."""
    mesh = _tp_group(p, cfg, tp_mesh)
    if mesh is None:
        return attn_out_mlp(p, o, x, cfg)
    return tp_out_mlp(p, o, x, cfg, mesh)


def _frame_axes(mesh: Mesh, n_frames: int):
    """JAX's ``_block_tp`` frame cut under a model extent: over data x
    context where it divides the frames, else none."""
    axes = _axes_over(mesh, (DATA_AXIS, CONTEXT_AXIS))
    n = _extent(mesh, axes)
    return axes if axes and n_frames % n == 0 else ()


def frame_block_sharded(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """``block()`` with the leading frame axis of ``x`` (F, P, C) cut over
    data x context; every rank returns the whole (F, P, C) output. With a
    model extent, Megatron's block on the frames cut (JAX's ``_block_tp``)."""
    mesh = active_mesh()
    if mesh is None:
        return block(p, x, cfg, rope_cos_sin)
    if tp_active(mesh):
        if not tp_divides(cfg, mesh.shape[MODEL_AXIS]):
            return block(p, x, cfg, rope_cos_sin)
        axes = _frame_axes(mesh, x.shape[0])
        pl = tp_replicated_params(p, mesh, axes)
        with activate_mesh(None):
            y = block_local(pl, scatter(x, mesh, axes, 0) if axes else x, cfg, rope_cos_sin,
                            mesh)
        return gather(y, mesh, axes, 0) if axes else y
    if not _frames_shardable(x.shape[0], mesh, (DATA_AXIS, CONTEXT_AXIS)):
        return block(p, x, cfg, rope_cos_sin)
    axes = _axes_over(mesh, (DATA_AXIS, CONTEXT_AXIS))
    with activate_mesh(None):
        y = block(replicate(p, mesh, axes), scatter(x, mesh, axes, 0), cfg, rope_cos_sin)
    return gather(y, mesh, axes, 0)


def reloc_block_sharded(p, x, context, cfg: BlockConfig, rope_q=None, rope_ctx=None):
    """``block_with_context()`` with query frames cut, the context whole on
    every rank of its scene.

    x: (B*Q, P, C) frame-major queries; context: (B, Nc, C) compressed scene
    tokens, cut over ``data`` when the data extent is above 1. Each rank's
    frames must land on the scene whose context it holds: whole scenes a
    rank (context extent 1), or the frames of one scene cut over context
    (B equal to the data extent); else the plain block runs (under a model
    extent, Megatron's block on every frame, JAX's ``_block_ctx_tp``)."""
    mesh = active_mesh()
    if mesh is None:
        return block_with_context(p, x, context, cfg, rope_q, rope_ctx)
    tp = tp_active(mesh)
    if tp and not tp_divides(cfg, mesh.shape[MODEL_AXIS]):
        return block_with_context(p, x, context, cfg, rope_q, rope_ctx)
    B, BF = context.shape[0], x.shape[0]
    Q = BF // B
    nd, nc = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
    ok = False
    if (nd * nc > 1 or _FORCE_SINGLE_DEVICE_SPMD) and B % nd == 0 and BF % (nd * nc) == 0:
        ok = nc == 1 or (B == nd and Q % nc == 0)
    if not ok and not tp:
        return block_with_context(p, x, context, cfg, rope_q, rope_ctx)
    axes = _axes_over(mesh, (DATA_AXIS, CONTEXT_AXIS)) if ok else ()
    with activate_mesh(None):
        if ok and nd > 1:
            context = scatter(context, mesh, DATA_AXIS, 0)
            if rope_ctx is not None:
                rope_ctx = tuple(scatter(t, mesh, DATA_AXIS, 0) for t in rope_ctx)
        if ok:
            # every context rank of a scene reads its whole context
            context = replicate(context, mesh, CONTEXT_AXIS)
        xl = scatter(x, mesh, axes, 0) if axes else x
        if tp:
            y = block_with_context_local(tp_replicated_params(p, mesh, axes), xl, context,
                                         cfg, rope_q, rope_ctx, mesh)
        else:
            y = block_with_context(replicate(p, mesh, axes), xl, context, cfg, rope_q,
                                   rope_ctx)
    return gather(y, mesh, axes, 0) if axes else y


def global_block_ring_local(p, x, cfg: BlockConfig, rope_cos_sin, mesh: Mesh,
                            tp_mesh: Optional[Mesh] = None):
    """The sequence-parallel block on this rank's tokens: x (B, N/n, C),
    the rank's chunk of the token axis in ``context`` order, and its slice
    of the (N, d) RoPE tables. With ``tp_mesh`` (JAX's ring with the head
    split) ``p`` is model-local: the ring runs on the rank's heads, the K/V
    chunks that rotate over ``context`` are theirs, and the tail is
    Megatron's over its model group. The parameters' gradient rule is the
    caller's."""
    tp = _tp_group(p, cfg, tp_mesh)
    if tp is not None:
        q, k, v = tp_qkv(p, x, cfg, rope_cos_sin, tp)
        return tp_out_mlp(p, ring_attention_local(q, k, v, mesh, cfg.attn_impl), x, cfg, tp)
    q, k, v = qkv_parts(p, x, cfg, rope_cos_sin)
    o = ring_attention_local(q, k, v, mesh, cfg.attn_impl)
    return attn_out_mlp(p, o, x, cfg)


def global_block_ring(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """Sequence-parallel block: the token axis of ``x`` (B, N, C) cut over
    ``context`` (the batch over ``data`` when it divides), ring attention,
    every rank returning the whole output; under a model extent each rank
    rides the ring with its head shard. Without a context extent that
    divides N (or with heads that the model extent does not divide) it is
    :func:`frame_block_sharded` (scenes over data, Megatron's block, else
    the plain block)."""
    mesh = active_mesh()
    nctx = mesh.shape[CONTEXT_AXIS] if mesh is not None else 1
    tp = tp_active(mesh)
    if (mesh is None or (nctx == 1 and not _FORCE_SINGLE_DEVICE_SPMD)
            or x.shape[1] % nctx or (tp and not tp_divides(cfg, mesh.shape[MODEL_AXIS]))):
        return frame_block_sharded(p, x, cfg, rope_cos_sin)
    nd = mesh.shape[DATA_AXIS]
    by_data = nd > 1 and x.shape[0] % nd == 0
    axes = (DATA_AXIS, CONTEXT_AXIS) if by_data else (CONTEXT_AXIS,)
    with activate_mesh(None):
        if by_data:
            x = scatter(x, mesh, DATA_AXIS, 0)
        x = scatter(x, mesh, CONTEXT_AXIS, 1)
        if rope_cos_sin is not None:
            rope_cos_sin = tuple(scatter(t, mesh, CONTEXT_AXIS, 0) for t in rope_cos_sin)
        pl = tp_replicated_params(p, mesh, axes) if tp else replicate(p, mesh, axes)
        y = global_block_ring_local(pl, x, cfg, rope_cos_sin, mesh, mesh if tp else None)
    y = gather(y, mesh, CONTEXT_AXIS, 1)
    return gather(y, mesh, DATA_AXIS, 0) if by_data else y


# -- the aggregator's layout ------------------------------------------------------


@dataclass(frozen=True)
class SceneShard:
    """The aggregator's sharded layout: scenes cut over ``data``, each
    scene's anchor and query frames cut over ``context``. With one scene a
    data rank and one data rank, a rank's anchors are exactly its chunk of
    the global-attention token axis.

    ``train_step``: the train step's layout. Its inputs hold this data
    rank's scenes already, so :meth:`scenes` cuts nothing, and the
    parameters enter without the per-leaf all-reduce rule: the step sums
    their gradients itself, in flat buckets.

    ``tp``: Megatron's blocks over ``model`` (a model extent above 1, or
    forced): the aggregator's blocks see model-local parameters (the train
    step's at-rest layout, or cut here from whole ones by
    :meth:`aggregator_params`) and run over :attr:`tp_mesh`; the patch
    embedding, the tokens and the heads run replicated on every model
    rank."""

    mesh: Mesh
    train_step: bool = False
    tp: bool = False

    @property
    def nd(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def nc(self) -> int:
        return self.mesh.shape[CONTEXT_AXIS]

    @property
    def nm(self) -> int:
        return self.mesh.shape[MODEL_AXIS]

    @property
    def context_index(self) -> int:
        return self.mesh.index(CONTEXT_AXIS)

    @property
    def tp_mesh(self) -> Optional[Mesh]:
        """The mesh whose ``model`` group the rank-local blocks reduce over
        (under ``tp``), else None."""
        return self.mesh if self.tp else None

    def heads(self, num_heads: int) -> int:
        """The heads a rank computes of a block of ``num_heads``."""
        return num_heads // self.nm if self.tp else num_heads

    def scenes(self, x, dim: int = 0):
        """The rank's scenes of a tensor whole on every rank."""
        if self.train_step:
            return x
        return scatter(x, self.mesh, DATA_AXIS, dim)

    def frames(self, x, dim: int):
        """The rank's frames (of the scenes it holds)."""
        return scatter(x, self.mesh, CONTEXT_AXIS, dim)

    def gather_frames(self, x, dim: int):
        """The scene's frames joined over ``context``, for the ranks to use
        on their own shards (the gradient is reduce-scattered)."""
        return gather_summed(x, self.mesh, CONTEXT_AXIS, dim)

    def shared(self, x):
        """The rank's scenes of a per-scene tensor whole on every rank, read
        by all of the rank's frames: its gradient is summed over
        ``context``."""
        return replicate(self.scenes(x), self.mesh, CONTEXT_AXIS)

    def gather_all(self, x, frame_dim: int = 1):
        """A per-frame output (B/nd, F/nc, ...) joined whole: (B, F, ...)."""
        x = gather(x, self.mesh, CONTEXT_AXIS, frame_dim)
        return gather(x, self.mesh, DATA_AXIS, 0)

    def replicate(self, tree):
        """Parameters used on every rank's shard: gradients summed over the
        mesh (unless the caller reduces them)."""
        if self.train_step:
            return tree
        return replicate(tree, self.mesh, (DATA_AXIS, CONTEXT_AXIS))

    def aggregator_params(self, p):
        """The aggregator's whole parameters as the rank-local body uses
        them: under ``tp`` each leaf of a block that runs Megatron's body
        (:func:`tp_block_leaf`) cut to the rank's part with Megatron's
        gradient rule (:func:`tp_replicated_params`), the rest replicated;
        the train step's are model-local already."""
        if self.train_step or not self.tp:
            return self.replicate(p)
        axes = (DATA_AXIS, CONTEXT_AXIS)

        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, path + (k,)) for k, v in node.items()}
            if isinstance(node, list):
                return [walk(v, path + (i,)) for i, v in enumerate(node)]
            sub = tp_block_leaf(path)
            return self.replicate(node) if sub is None else _tp_leaf(node, sub, self.mesh,
                                                                      axes)

        return walk(p, ("aggregator",))


def tp_block_leaf(path) -> Optional[tuple]:
    """Where a params leaf at ``path`` (keys from the model's params down)
    sits in a block that runs Megatron's body under tensor parallelism (the
    aggregator's frame, global and reloc blocks and its ViT's): its keys
    from the block down, else None (the patch embedding, the tokens, the
    heads: replicated on every model rank). The one rule for which leaves
    Megatron cuts, or holds a part of the gradient of."""
    keys = tuple(path)
    if keys[:1] != ("aggregator",):
        return None
    if keys[1:2] and keys[1] in ("frame_blocks", "global_blocks", "reloc_blocks"):
        return keys[3:]
    if keys[1:3] == ("vit", "blocks"):
        return keys[4:]
    return None


def scene_shard(num_scenes: int, *frame_counts: int, train_step: bool = False,
                tp: bool = False) -> Optional[SceneShard]:
    """The sharded layout under the active mesh, or None for the replicated
    path: no mesh, extents of 1 (unless forced), scenes that do not divide
    the data extent or a frame count that does not divide the context
    extent (JAX's fallback when an axis does not divide). ``tp``: the
    caller's :func:`tp_engaged` (Megatron's blocks over ``model``); without
    it a model extent above 1 runs the whole model on each of its ranks."""
    mesh = active_mesh()
    if mesh is None:
        return None
    nd, nc = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
    if nd * nc == 1 and not (_FORCE_SINGLE_DEVICE_SPMD or tp):
        return None
    if num_scenes % nd or any(f % nc for f in frame_counts):
        return None
    return SceneShard(mesh, train_step, tp)
