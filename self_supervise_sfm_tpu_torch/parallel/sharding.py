"""Process mesh and the collectives of explicit SPMD.

Port of ``self_supervise_sfm_tpu/parallel/sharding.py``. The mesh has the
JAX package's three axes: ``data`` (whole scenes per rank), ``context``
(sequence parallelism over the long global-attention token axis and the
scene cache's token axis) and ``model`` (tensor parallelism: attention heads
and the MLP's hidden width cut over it, Megatron's blocks in
``parallel/sp_block.py``).

JAX holds global arrays and lets GSPMD and ``shard_map`` move them. The port
is plain SPMD instead: one process a rank, each holding its shard, and every
place where JAX calls ``constrain`` or opens a ``shard_map`` is an explicit
slice or collective here. The port has no ``constrain``. Each collective is
a ``torch.autograd.Function`` with an explicit gradient rule:

============================  =====================  ======================
function                      forward                backward
============================  =====================  ======================
:func:`replicate`             identity               all-reduce (sum)
:func:`scatter`               the rank's slice       all-gather
:func:`gather`                all-gather             the rank's slice
:func:`gather_summed`         all-gather             reduce-scatter (sum)
:func:`post_ring_shift`       send to i+1,           the reverse rotation
                              receive from i-1
:func:`reduce_from_model`     all-reduce (sum)       identity
============================  =====================  ======================

Megatron's two operators are :func:`replicate` over ``model`` at the input
of a column-parallel half (the input whole on every rank of a model group,
each rank's branch a part of its gradient) and :func:`reduce_from_model` at
the output of a row-parallel half (each rank's product a part of the sum,
the sum's gradient whole on every rank).

``replicate`` is a replicated parameter used on a local shard (JAX's
``shard_map`` transpose of a ``P()`` input psums it). ``scatter`` takes a
rank's part of a tensor that every rank holds whole, and ``gather`` joins
the parts into a whole that every rank then uses alike. ``gather_summed``
joins a tensor that the ranks then use on different shards (the compressed
scene that every rank's reloc queries read), so each rank holds a part of
its gradient. The ring shift is JAX's ``ppermute``, which it transposes to
the inverse permutation. A loss under the mesh is either computed alike on
every rank from gathered outputs, or the sum of the ranks' losses over their
own shards; these rules give the true gradient in both cases.

The process group is the caller's: ``torch.distributed.init_process_group``
with NCCL for a mesh on ``cuda`` (one card a rank), gloo for one on the CPU.
:func:`make_mesh` refuses any other pairing.

Training's parameter layout is JAX's rule: :func:`param_sharding` gives each
leaf of a tree a spec (one entry a dim, a mesh axis or None, as a
``PartitionSpec``), FSDP's ZeRO-3 cut over ``data`` composed with the
Megatron cut over ``model``. :func:`shard_tree` keeps a rank's slice of
each leaf and :func:`gather_tree` joins them again. A leaf's part of the
``model`` axis is its rank's heads or hidden units, cut first: a qkv
leaf's columns of q, of k and of v for the rank's heads, in
``[q_l | k_l | v_l]`` order (:func:`model_groups`, JAX's
``_tp_local_attn``), not the contiguous third of ``[q | k | v]`` that
JAX's spec names (its blocks slice per head and XLA reshards every use);
the ``data`` cut then applies to that part. The train step reduces
gradients after its backward in flat buffers of :data:`BUCKET_BYTES`
(:func:`bucketed_all_reduce`, :func:`bucketed_reduce_scatter`) and gathers
FSDP's shards the same way (:func:`bucketed_all_gather`), so that a step
makes collectives of the order of its buckets, not of its ~1800 leaves.
:data:`collective_counts` counts every collective this module issues.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

_state = threading.local()

DATA_AXIS = "data"
CONTEXT_AXIS = "context"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, CONTEXT_AXIS, MODEL_AXIS)

Axes = Union[str, Sequence[str]]


def _axes(axes: Axes) -> Tuple[str, ...]:
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    if not names or any(a not in AXES for a in names):
        raise ValueError(f"mesh axes {axes!r}: each must be one of {AXES}")
    # data-major, as JAX orders a tuple of axes in a PartitionSpec
    return tuple(a for a in AXES if a in names)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A (data, context, model) mesh of ranks with one process group per axis
    and one over (data, context). ``shape`` maps each axis to its extent, as
    JAX's ``Mesh.shape``; ``coordinate`` is this rank's place, None on a rank
    outside the mesh."""

    shape: Dict[str, int]
    device: torch.device
    coordinate: Optional[Tuple[int, int, int]]
    groups: Dict[Tuple[str, ...], object]

    def size(self, axes: Axes) -> int:
        return int(np.prod([self.shape[a] for a in _axes(axes)]))

    def group(self, axes: Axes):
        if self.coordinate is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside this mesh")
        key = _axes(axes)
        if key not in self.groups:
            raise ValueError(f"the mesh has no process group over {key}")
        return self.groups[key]

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (row-major, data first)."""
        if self.coordinate is None:
            raise RuntimeError(f"rank {dist.get_rank()} is outside this mesh")
        i = 0
        for a in _axes(axes):
            i = i * self.shape[a] + self.coordinate[AXES.index(a)]
        return i


def make_mesh(num_data: Optional[int] = None, num_context: int = 1, num_model: int = 1,
              device="cuda") -> Mesh:
    """Build a (data, context, model) mesh over the ranks of the default
    process group, which the caller has started. Every rank must call it
    (it creates process groups); extents whose product is below the world
    use its first ranks, and the others get a mesh they are not in.
    ``num_data`` defaults to the world over context x model."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: no process group; call torch.distributed.init_process_group "
            "first (NCCL on cuda, gloo on the CPU)")
    dev = torch.device(device)
    backend = dist.get_backend()
    want = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if want is None or backend != want:
        raise ValueError(
            f"make_mesh: a mesh on {dev.type} runs on the {want} backend, the process "
            f"group runs {backend}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // (num_context * num_model)
    extents = (num_data, num_context, num_model)
    total = int(np.prod(extents))
    if min(extents) < 1 or total > world:
        raise ValueError(
            f"mesh {num_data}x{num_context}x{num_model} exceeds the world of {world} ranks")
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    if total == world:
        dm = init_device_mesh(dev.type, extents, mesh_dim_names=AXES)
    else:
        dm = DeviceMesh(dev.type, torch.arange(total).reshape(extents), mesh_dim_names=AXES)
    ranks = np.arange(total).reshape(extents)
    me = dist.get_rank()
    coordinate = None
    if me < total:
        coordinate = tuple(int(c) for c in np.argwhere(ranks == me)[0])
    groups: Dict[Tuple[str, ...], object] = {}
    # the (data, context) group of each model index; every rank creates all
    # of them, as new_group requires
    for m in range(num_model):
        g = dist.new_group(ranks=[int(r) for r in ranks[:, :, m].ravel()])
        if coordinate is not None and coordinate[2] == m:
            groups[(DATA_AXIS, CONTEXT_AXIS)] = g
    if coordinate is not None:
        for a in AXES:
            groups[(a,)] = dm.get_group(a)
    return Mesh(dict(zip(AXES, extents)), dev, coordinate, groups)


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def activate_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the sharded blocks and entry points see."""
    prev = active_mesh()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def shard_batch(batch: dict, mesh: Mesh, process_local: bool = False) -> dict:
    """This rank's slice of the leading (scene) axis of each numeric leaf of
    a host batch, over the ``data`` axis, as tensors on the mesh's device.

    ``process_local``: the batch already holds only this rank's scenes (each
    rank loaded its own); they are moved to the device as they are. By
    default the batch is the whole value on every rank (replicated host
    data), as JAX's ``shard_batch``."""
    n, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) >= 1:
            t = torch.as_tensor(v)
            if not process_local:
                if t.shape[0] % n:
                    raise ValueError(
                        f"shard_batch: {k} has {t.shape[0]} scenes for {n} data ranks")
                m = t.shape[0] // n
                t = t[i * m: (i + 1) * m]
            out[k] = t.to(mesh.device)
        else:
            out[k] = v
    return out


# -- the collectives ------------------------------------------------------------


# collectives issued by this module, by kind (the caller resets it)
collective_counts: "collections.Counter[str]" = collections.Counter()


def _own_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"axis {dim} of {tuple(x.shape)} does not split over {n} ranks")
    m = x.shape[dim] // n
    return x.narrow(dim, i * m, m)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """One all-gather into one buffer (half the host cost of the list form
    on the card), then the ranks' parts moved to ``dim``."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    collective_counts["all_gather"] += 1
    # all_gather_single is all_gather_into_tensor's newer name
    (getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor)(
        out, x, group=group)
    if n == 1 or dim == 0:
        return out
    shape = list(x.shape)
    shape[dim] *= n
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(dist.get_world_size(group), dim=dim)]
    out = torch.empty_like(parts[0])
    collective_counts["reduce_scatter"] += 1
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    collective_counts["all_reduce"] += 1
    dist.all_reduce(x, group=group)
    return x


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _all_reduce(g, ctx.group)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return None, None, _all_gather(g, ctx.group, ctx.dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, _own_slice(g, ctx.group, ctx.dim).contiguous()


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, dim, x):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return None, None, _reduce_scatter(g, ctx.group, ctx.dim)


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return None, g


def reduce_from_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the rank's ``model`` group: the output of a
    row-parallel product, each rank's part of the sum computed from its
    heads or hidden units. The gradient is the sum's, whole on every rank
    (Megatron's ``g``)."""
    return _ReduceFromModel.apply(mesh.group(MODEL_AXIS), x)


def replicate(tree, mesh: Mesh, axes: Axes):
    """Each tensor leaf of ``tree`` (nested dicts and lists) as it is, with
    its gradient summed over ``axes``: a replicated parameter used on this
    rank's shard. Outside grad mode the tree is returned untouched."""
    if not torch.is_grad_enabled():
        return tree
    group = mesh.group(axes)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if torch.is_tensor(node) and node.requires_grad:
            return _Replicate.apply(group, node)
        return node

    return walk(tree)


def scatter(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` (whole on every rank) along ``dim`` over
    ``axes``; the gradient is gathered back whole."""
    return _Scatter.apply(mesh.group(axes), dim, x)


def gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """The ranks' parts of ``x`` joined along ``dim`` over ``axes``, for
    consumers that use the whole alike; the gradient is the rank's slice."""
    return _Gather.apply(mesh.group(axes), dim, x)


def gather_summed(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int) -> torch.Tensor:
    """As :func:`gather`, for a whole that the ranks use on different shards:
    the gradient is reduce-scattered (summed over the ranks)."""
    return _GatherSummed.apply(mesh.group(axes), dim, x)


def _exchange(xs, group, shift: int):
    """Post sends of ``xs`` to the rank ``shift`` ahead on ``group``'s ring
    and receives from the rank ``shift`` behind; (received buffers, wait)."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + shift) % n)
    src = dist.get_global_rank(group, (i - shift) % n)
    sends = [x.contiguous() for x in xs]
    outs = [torch.empty_like(x) for x in sends]
    ops = ([dist.P2POp(dist.isend, x, dst, group) for x in sends]
           + [dist.P2POp(dist.irecv, o, src, group) for o in outs])
    collective_counts["ring_shift"] += 1
    reqs = dist.batch_isend_irecv(ops)

    def wait():
        for r in reqs:
            r.wait()
        sends.clear()

    return outs, wait


class _RingShift(torch.autograd.Function):
    """One rotation of the ring: each rank sends its tensors to the next rank
    and receives the previous rank's. The forward only posts the exchange
    (the caller waits before reading what arrives); the backward rotates
    the gradients the other way and waits."""

    @staticmethod
    def forward(ctx, waits, group, *xs):
        ctx.group = group
        outs, wait = _exchange(xs, group, +1)
        waits.append(wait)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        outs, wait = _exchange(gs, ctx.group, -1)
        wait()
        return (None, None, *outs)


def post_ring_shift(mesh: Mesh, axis: str, *xs: torch.Tensor):
    """Post one rotation of ``xs`` around ``axis``'s ring: returns (the
    tensors that will arrive, wait). Call ``wait()`` before reading them;
    what runs in between overlaps the exchange."""
    waits = []
    outs = _RingShift.apply(waits, mesh.group(axis), *xs)
    return outs, waits[0]


# -- training's parameter layout (JAX's param_sharding) -------------------------

Spec = Tuple[Optional[str], ...]

# Megatron-style tensor-parallel dims, keyed on the trailing param path:
# column-parallel weights (output dim cut: attention QKV, MLP up) and
# row-parallel weights (input dim cut: attention out-proj, MLP down). Dims
# are negative so that a stacked layer axis in front changes nothing.
_TP_COLUMN = {"qkv": ("attn",), "fc1": (), "w12": ()}
_TP_ROW = {"proj": ("attn",), "fc2": (), "w3": ()}
# leaves below this many elements stay whole: cutting them saves nothing
MIN_SHARD_ELEMS = 1 << 16
# the size of one flat buffer of the train step's collectives
BUCKET_BYTES = 64 << 20


def _tp_dim(path) -> Optional[int]:
    """The dim a leaf at ``path`` is cut on over ``model``, or None. The
    path's string entries are dict keys; anything else (list indices) is
    skipped, as JAX skips non-dict keys."""
    keys = [k for k in path if isinstance(k, str)]
    if len(keys) < 2:
        return None
    parent, leaf = keys[-2], keys[-1]
    anc = set(keys[:-1])

    def guarded(table):
        req = table.get(parent)
        return req is not None and all(r in anc for r in req)

    if guarded(_TP_COLUMN):
        return -1  # w: (..., in, out) / b: (..., out)
    if guarded(_TP_ROW) and leaf == "w":
        return -2  # w: (..., in, out); a row-parallel layer's bias stays whole
    return None


def leaf_spec(path, shape, nd: int = 1, nm: int = 1, force: bool = False) -> Spec:
    """JAX's ``param_sharding`` rule for one leaf of ``shape`` at ``path``:
    with ``nm`` > 1 the Megatron dim over ``model`` (where ``nm`` divides
    it), then with ``nd`` > 1 (or ``force``) the largest remaining dim that
    ``nd`` divides over ``data``, for a leaf of at least
    :data:`MIN_SHARD_ELEMS` elements. ``force`` takes the FSDP cut at a data
    extent of 1 too (``force_single_device_spmd``)."""
    shape = tuple(int(s) for s in shape)
    spec: List[Optional[str]] = [None] * len(shape)
    if not shape:
        return ()
    if nm > 1:
        d = _tp_dim(path)
        if d is not None and shape[d] % nm == 0:
            spec[d % len(shape)] = MODEL_AXIS
    if (nd > 1 or force) and int(np.prod(shape)) >= MIN_SHARD_ELEMS:
        for d in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
            if spec[d] is None and shape[d] % nd == 0 and shape[d] >= nd:
                spec[d] = DATA_AXIS
                break
    return tuple(spec)


def _extents(mesh) -> Dict[str, int]:
    return dict(mesh.shape) if isinstance(mesh, Mesh) else dict(mesh)


def param_sharding(mesh, tree, fsdp: bool = False, tp: bool = False, force: bool = False):
    """The spec of every leaf of ``tree`` (nested dicts and lists of tensors
    or anything with a ``shape``), as a tree of the same layout: ``fsdp``
    cuts over ``data`` (ZeRO-3), ``tp`` over ``model``, composed as JAX
    composes them. ``mesh`` is a :class:`Mesh` or a dict of axis extents.
    A leaf without a shape gets ``()``."""
    ext = _extents(mesh)
    nd = ext.get(DATA_AXIS, 1) if fsdp else 1
    nm = ext.get(MODEL_AXIS, 1) if tp else 1

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if node is None:
            return None
        if not hasattr(node, "shape"):
            return ()
        return leaf_spec(path, node.shape, nd, nm, force and fsdp)

    return walk(tree, ())


def fsdp_sharding(mesh, tree):
    """FSDP / ZeRO-3 specs (see :func:`param_sharding`)."""
    return param_sharding(mesh, tree, fsdp=True)


def leaves_like(tree, other) -> list:
    """The leaves of ``other`` (a tree with ``tree``'s keys: its specs, say)
    in the order of ``tree``'s leaves, matched by key, not by position (two
    trees of one model may hold their dict keys in different orders)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in leaves_like(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, o in zip(tree, other) for x in leaves_like(t, o)]
    return [] if tree is None else [other]


def spec_leaves(specs) -> List[Spec]:
    """The specs of a :func:`param_sharding` tree in the order of its
    leaves (a spec is a tuple; the tree's sequences are lists)."""
    if isinstance(specs, dict):
        return [s for k in specs for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [] if specs is None else [specs]


def data_dim(spec: Spec) -> Optional[int]:
    """The dim a spec cuts over ``data``, or None."""
    return spec.index(DATA_AXIS) if DATA_AXIS in spec else None


def model_dim(spec: Spec) -> Optional[int]:
    """The dim a spec cuts over ``model``, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def model_groups(path) -> int:
    """The column groups of a leaf whose ``model`` cut takes each group's
    part: 3 for an attention qkv weight or bias (a rank holds its heads'
    columns of q, of k and of v), else 1 (one contiguous part)."""
    keys = [k for k in path if isinstance(k, str)]
    return 3 if len(keys) >= 3 and keys[-3:-1] == ["attn", "qkv"] else 1


def model_part(x: torch.Tensor, d: int, n: int, i: int, groups: int = 1) -> torch.Tensor:
    """Part ``i`` of ``n`` of ``x`` along ``d`` over ``model``: in each of
    ``groups`` equal runs of the dim, its i-th n-th (a view when groups is 1;
    differentiable)."""
    d = d % x.dim()
    size = x.shape[d]
    if size % (groups * n):
        raise ValueError(f"axis {d} of {tuple(x.shape)} does not split into {groups} x {n} parts")
    m = size // (groups * n)
    if groups == 1:
        return x.narrow(d, i * m, m)
    parts = x.unflatten(d, (groups, n, m)).select(d + 1, i)
    return parts.flatten(d, d + 1)


def join_model_parts(parts: Sequence[torch.Tensor], d: int, groups: int = 1) -> torch.Tensor:
    """The inverse of :func:`model_part` over its ``n`` parts, in rank order."""
    d = d % parts[0].dim()
    if groups == 1:
        return torch.cat(list(parts), dim=d)
    split = [p.unflatten(d, (groups, p.shape[d] // groups)) for p in parts]
    return torch.stack(split, dim=d + 1).flatten(d, d + 2)


def _map_leaves(tree, specs, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, specs[k], fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_leaves(v, s, fn, path + (i,)) for i, (v, s) in enumerate(zip(tree, specs))]
    return None if tree is None else fn(tree, specs, path)


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of a rank's slice of a leaf of ``shape`` under ``spec``."""
    ext = _extents(mesh)
    out = list(shape)
    for d, a in enumerate(spec):
        if a is not None:
            out[d] //= ext.get(a, 1)
    return tuple(out)


def shard_of(x: torch.Tensor, spec: Spec, mesh: Mesh, groups: int = 1) -> torch.Tensor:
    """This rank's slice of a whole leaf ``x`` under ``spec``, in its own
    contiguous storage (the whole can be freed): its part over ``model``
    (``groups`` as :func:`model_groups`), then of that its part over
    ``data``."""
    md, d = model_dim(spec), data_dim(spec)
    if md is None and d is None:
        return x
    if md is not None:
        x = model_part(x, md, mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS), groups)
    if d is not None:
        n = mesh.shape[DATA_AXIS]
        m = x.shape[d] // n
        x = x.narrow(d, mesh.index(DATA_AXIS) * m, m)
    return x.clone(memory_format=torch.contiguous_format)


def shard_tree(tree, specs, mesh: Mesh):
    """This rank's slice of every leaf of ``tree`` (whole on every rank)."""
    return _map_leaves(tree, specs, lambda x, s, path: shard_of(x, s, mesh, model_groups(path)))


def gather_tree(tree, specs, mesh: Mesh, to_rank: Optional[int] = None, device=None):
    """Every leaf of ``tree`` (this rank's shards) whole, gathered one leaf at
    a time over ``data``, then over ``model``. Every rank of the mesh must
    call it. With ``to_rank`` only that rank (of the world) keeps the
    result; the others get None. ``device``: where each whole leaf goes as
    soon as it is gathered (the host, for a checkpoint), so that the whole
    tree never sits on the card."""
    keep = to_rank is None or dist.get_rank() == to_rank

    def one(x, spec, path):
        d, md = data_dim(spec), model_dim(spec)
        whole = x if d is None else _all_gather(x, mesh.group(DATA_AXIS), d)
        if md is not None:
            parts = _all_gather(whole.unsqueeze(0), mesh.group(MODEL_AXIS), 0)
            whole = join_model_parts(list(parts.unbind(0)), md, model_groups(path))
        if not keep:
            return None
        if device is not None:
            return whole.detach().to(device, copy=True)
        return whole if (d is not None or md is not None) else x

    out = _map_leaves(tree, specs, one)
    return out if keep else None


# each tensor of a flat buffer starts at a multiple of this many elements
# (512 bytes of fp32, where the caching allocator puts a fresh tensor), so
# that a vectorised kernel reading a view of the buffer (a reduction: the
# gradient norm) takes the path it takes on a tensor of its own
_ALIGN = 128


def _pack(parts: Sequence[torch.Tensor], dim: int = 0):
    """Tensors of one dtype, equal but along ``dim``, joined along ``dim``
    with zeros after each up to a multiple of :data:`_ALIGN`: (buffer,
    the offsets along ``dim``)."""
    pieces, offsets, total = [], [], 0
    for t in parts:
        n = t.shape[dim]
        pad = -n % _ALIGN
        offsets.append(total)
        pieces.append(t)
        if pad:
            shape = list(t.shape)
            shape[dim] = pad
            pieces.append(t.new_zeros(shape))
        total += n + pad
    return torch.cat(pieces, dim=dim), offsets


def _memory_order(t: torch.Tensor) -> List[int]:
    """The permutation of ``t``'s dims that its storage is laid out in (a
    gradient of a convolution may come channels-last), so that a flat copy
    and the view back keep its strides; the dims' own order when ``t`` is
    not dense."""
    perm = sorted(range(t.dim()), key=lambda i: (-t.stride(i), -t.shape[i]))
    return perm if t.permute(perm).is_contiguous() else list(range(t.dim()))


def _unpermute(x: torch.Tensor, perm: List[int]) -> torch.Tensor:
    return x.permute([perm.index(i) for i in range(len(perm))])


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Index ranges over ``tensors`` of one dtype and at most
    ``bucket_bytes`` each (or one tensor)."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if i > start and (size + nbytes > bucket_bytes or t.dtype != tensors[start].dtype):
            yield range(start, i)
            start, size = i, 0
        size += nbytes
    if start < len(tensors):
        yield range(start, len(tensors))


def bucketed_all_reduce(tensors: List[torch.Tensor], mesh: Mesh, axes: Axes,
                        bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """The sum of each tensor over ``axes``: the tensors copied into flat
    buffers of at most ``bucket_bytes``, each buffer summed in place by one
    all-reduce. Returns views of the buffers in the tensors' shapes; the
    list's entries are dropped as their bucket is copied, so the caller's
    tensors can be freed along the way. Each view has its tensor's strides."""
    group = mesh.group(axes)
    out: List[torch.Tensor] = []
    for idx in list(_buckets(tensors, bucket_bytes)):
        perms = [_memory_order(tensors[i]) for i in idx]
        views = [tensors[i].permute(p) for i, p in zip(idx, perms)]
        flat, offsets = _pack([v.reshape(-1) for v in views])
        shapes = [v.shape for v in views]
        del views
        for i in idx:
            tensors[i] = None
        collective_counts["all_reduce"] += 1
        dist.all_reduce(flat, group=group)
        out += [_unpermute(flat[o: o + s.numel()].view(s), p)
                for o, s, p in zip(offsets, shapes, perms)]
    return out


def bucketed_all_gather(shards: Sequence[torch.Tensor], dims: Sequence[int], mesh: Mesh,
                        bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """Each shard joined whole along its dim in ``dims`` over ``data``, by one
    all-gather of a flat buffer a bucket (``bucket_bytes`` of shards)."""
    group = mesh.group(DATA_AXIS)
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = []
    for idx in _buckets(shards, bucket_bytes):
        sizes = [shards[i].numel() for i in idx]
        flat = _all_gather(torch.cat([shards[i].reshape(-1) for i in idx]), group, 0)
        for i, part in zip(idx, flat.view(n, -1).split(sizes, dim=1)):
            s, d = shards[i].shape, dims[i]
            whole = list(s)
            whole[d] *= n
            out.append(part.reshape(n, *s).movedim(0, d).reshape(whole))
    return out


def bucketed_reduce_scatter(wholes: List[torch.Tensor], dims: Sequence[int], mesh: Mesh,
                            bucket_bytes: int = BUCKET_BYTES) -> List[torch.Tensor]:
    """This rank's slice, along its dim in ``dims``, of each tensor summed
    over ``data``: one reduce-scatter of a flat buffer a bucket. The list's
    entries are dropped as their bucket is copied. Each slice has the
    memory order of its tensor."""
    group = mesh.group(DATA_AXIS)
    n = dist.get_world_size(group)
    out: List[torch.Tensor] = []
    for idx in list(_buckets(wholes, bucket_bytes)):
        shapes, perms, rows = [], [], []
        for i in idx:
            perm = _memory_order(wholes[i])
            g, d = wholes[i].permute(perm), perm.index(dims[i])
            s = list(g.shape)
            s[d] //= n
            shapes.append(s)
            perms.append(perm)
            rows.append(g.unflatten(d, (n, s[d])).movedim(d, 0).reshape(n, -1))
            wholes[i] = None
        flat, offsets = _pack(rows, dim=1)
        del rows
        part = torch.empty_like(flat[0])
        collective_counts["reduce_scatter"] += 1
        dist.reduce_scatter(part, list(flat.unbind(0)), group=group)
        del flat
        out += [_unpermute(part[o: o + int(np.prod(s))].view(s), p)
                for o, s, p in zip(offsets, shapes, perms)]
    return out
