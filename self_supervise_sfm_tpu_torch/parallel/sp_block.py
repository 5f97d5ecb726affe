"""Frame- and sequence-parallel transformer blocks over the process mesh.

Port of ``self_supervise_sfm_tpu/parallel/sp_block.py`` (its data and
context parts). Three variants, one for each attention site of the
aggregator:

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

The port needs no mesh gate on the fused kernels (JAX's
``layers/block.py`` turns them off under a multi-device mesh, since a
``pallas_call`` is opaque to GSPMD): its blocks only ever see rank-local
shards. Tensor parallelism (JAX's ``_tp_local_attn``, ``_tp_out_mlp``,
``_block_tp``, ``_block_ctx_tp``) is not ported: a ``model`` extent above 1
raises :class:`NotImplementedError` naming ROADMAP.md Queue A item 3d.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional, Tuple

from ..layers.block import BlockConfig, attn_out_mlp, block, block_with_context, qkv_parts
from ..ops.ring_attention import ring_attention_local
from .sharding import (
    CONTEXT_AXIS, DATA_AXIS, MODEL_AXIS, Mesh, activate_mesh, active_mesh, gather,
    gather_summed, replicate, scatter,
)

# Validation hook: with it on, the sharded paths stay engaged when every
# mesh axis has extent 1. A world of one rank then runs the exact sharded
# program each rank of a larger mesh runs (a ring of one chunk, collectives
# over groups of one): the way to run it on a machine with one card, where
# NCCL takes one rank a device.
_FORCE_SINGLE_DEVICE_SPMD = False

TP_REFUSAL = (
    "tensor parallelism (a 'model' mesh extent above 1) is not ported yet: "
    "ROADMAP.md Queue A item 3d; multi-device training and serving run the "
    "data and context axes")


@contextlib.contextmanager
def force_single_device_spmd():
    global _FORCE_SINGLE_DEVICE_SPMD
    prev = _FORCE_SINGLE_DEVICE_SPMD
    _FORCE_SINGLE_DEVICE_SPMD = True
    try:
        yield
    finally:
        _FORCE_SINGLE_DEVICE_SPMD = prev


def _refuse_tp(mesh: Optional[Mesh]) -> None:
    if mesh is not None and mesh.shape.get(MODEL_AXIS, 1) > 1:
        raise NotImplementedError(TP_REFUSAL)


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
    if mesh is None or mesh.shape.get(MODEL_AXIS, 1) > 1:
        return False
    n = _extent(mesh, _axes_over(mesh, axes))
    return (n > 1 or _FORCE_SINGLE_DEVICE_SPMD) and n_frames % n == 0


def frame_block_sharded(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """``block()`` with the leading frame axis of ``x`` (F, P, C) cut over
    data x context; every rank returns the whole (F, P, C) output."""
    mesh = active_mesh()
    _refuse_tp(mesh)
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
    (B equal to the data extent); else the plain block runs."""
    mesh = active_mesh()
    _refuse_tp(mesh)
    B, BF = context.shape[0], x.shape[0]
    Q = BF // B
    ok = False
    if mesh is not None:
        nd, nc = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
        if (nd * nc > 1 or _FORCE_SINGLE_DEVICE_SPMD) and B % nd == 0 and BF % (nd * nc) == 0:
            ok = nc == 1 or (B == nd and Q % nc == 0)
    if not ok:
        return block_with_context(p, x, context, cfg, rope_q, rope_ctx)
    axes = _axes_over(mesh, (DATA_AXIS, CONTEXT_AXIS))
    with activate_mesh(None):
        if mesh.shape[DATA_AXIS] > 1:
            context = scatter(context, mesh, DATA_AXIS, 0)
            if rope_ctx is not None:
                rope_ctx = tuple(scatter(t, mesh, DATA_AXIS, 0) for t in rope_ctx)
        # every context rank of a scene reads its whole context
        context = replicate(context, mesh, CONTEXT_AXIS)
        y = block_with_context(replicate(p, mesh, axes), scatter(x, mesh, axes, 0),
                               context, cfg, rope_q, rope_ctx)
    return gather(y, mesh, axes, 0)


def global_block_ring_local(p, x, cfg: BlockConfig, rope_cos_sin, mesh: Mesh):
    """The sequence-parallel block on this rank's tokens: x (B, N/n, C),
    the rank's chunk of the token axis in ``context`` order, and its slice
    of the (N, d) RoPE tables. The parameters' gradient rule is the
    caller's."""
    q, k, v = qkv_parts(p, x, cfg, rope_cos_sin)
    o = ring_attention_local(q, k, v, mesh, cfg.attn_impl)
    return attn_out_mlp(p, o, x, cfg)


def global_block_ring(p, x, cfg: BlockConfig, rope_cos_sin=None):
    """Sequence-parallel block: the token axis of ``x`` (B, N, C) cut over
    ``context`` (the batch over ``data`` when it divides), ring attention,
    every rank returning the whole output. Without a context extent that
    divides N it is :func:`frame_block_sharded` (scenes over data, else the
    plain block)."""
    mesh = active_mesh()
    _refuse_tp(mesh)
    nctx = mesh.shape[CONTEXT_AXIS] if mesh is not None else 1
    if (mesh is None or (nctx == 1 and not _FORCE_SINGLE_DEVICE_SPMD)
            or x.shape[1] % nctx):
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
        y = global_block_ring_local(replicate(p, mesh, axes), x, cfg, rope_cos_sin, mesh)
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
    their gradients itself, in flat buckets."""

    mesh: Mesh
    train_step: bool = False

    @property
    def nd(self) -> int:
        return self.mesh.shape[DATA_AXIS]

    @property
    def nc(self) -> int:
        return self.mesh.shape[CONTEXT_AXIS]

    @property
    def context_index(self) -> int:
        return self.mesh.index(CONTEXT_AXIS)

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


def scene_shard(num_scenes: int, *frame_counts: int,
                train_step: bool = False) -> Optional[SceneShard]:
    """The sharded layout under the active mesh, or None for the replicated
    path: no mesh, extents of 1 (unless forced), scenes that do not divide
    the data extent or a frame count that does not divide the context
    extent (JAX's fallback when an axis does not divide)."""
    mesh = active_mesh()
    _refuse_tp(mesh)
    if mesh is None:
        return None
    nd, nc = mesh.shape[DATA_AXIS], mesh.shape[CONTEXT_AXIS]
    if nd * nc == 1 and not _FORCE_SINGLE_DEVICE_SPMD:
        return None
    if num_scenes % nd or any(f % nc for f in frame_counts):
        return None
    return SceneShard(mesh, train_step)
