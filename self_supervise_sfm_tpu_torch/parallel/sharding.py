"""Process mesh and the collectives of explicit SPMD.

Port of ``self_supervise_sfm_tpu/parallel/sharding.py``. The mesh has the
JAX package's three axes: ``data`` (whole scenes per rank), ``context``
(sequence parallelism over the long global-attention token axis and the
scene cache's token axis) and ``model`` (tensor parallelism, which the port
does not run yet: every sharded block refuses a ``model`` extent above 1).

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
============================  =====================  ======================

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
:func:`make_mesh` refuses any other pairing. ``param_sharding`` and
``fsdp_sharding`` belong to training and are not ported yet.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple, Union

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
    dist.reduce_scatter(out, parts, group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
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
