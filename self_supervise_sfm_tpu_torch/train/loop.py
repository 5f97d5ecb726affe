"""The self-supervised train step: loss, gradients and an optax-style Adam.

Port of ``self_supervise_sfm_tpu/train/loop.py``. One step runs the trunk
(ViT + aggregator, in the compute dtype) and the fp32 camera head on the
duplicated layout (anchors = queries = the scene's frames, the ViT once per
unique image), scores the predicted extrinsics and intrinsics of every
scene with :func:`..train.loss.scene_loss`, takes the gradients of the mean
loss through every kernel's ``torch.autograd.Function``, and updates the fp32
master parameters with Adam under a linear-warmup cosine schedule.

The DPT depth and point heads are not run: nothing of the loss reads them,
so the JAX step's gradients for them are zero (XLA drops the heads) and
optax's Adam moves them by exactly 0 (m = v = 0 stay 0 and the update is
0 / (0 + eps)). The port leaves their parameters and moments untouched and
reports their gradient norms as 0.0.

The state is a dict ``{"params", "opt": {"mu", "nu", "count"}, "step"}``;
``mu`` / ``nu`` mirror the params tree (``mu`` in ``adam_mu_dtype``). A step
updates the state's tensors in place (the master weights, the moments) and
returns the same dict: JAX returns a new state, but here that would hold a
second copy of ~18 GB at full width.

Under an active mesh (``parallel/sharding.py:activate_mesh``) the step is
explicit SPMD over the ``data`` and ``context`` axes, one process a rank
(:func:`sharded_loss_and_grads`): scenes cut over ``data``, each scene's
frames and global-attention tokens over ``context`` (the aggregator's
``SceneShard`` layout: the ring on the global block, K2 on the rank's
reloc queries), the camera head on the rank's queries, and the global mean
loss computed alike on every rank from the gathered pose encodings. The
trained leaves enter without a per-leaf collective; their gradients are
summed after the backward in flat buckets (DDP). With ``TrainConfig.fsdp``
and a data extent above 1 (or ``force_single_device_spmd``) the
parameters and both Adam moments are cut over ``data`` by JAX's ZeRO-3
rule (:class:`StateLayout`): the step casts each rank's trunk shards to
the compute dtype, gathers them whole once (bucketed all-gathers, half the
bytes of fp32), and reduce-scatters the gradients back onto the shards,
where Adam runs. The gradient norm sums each rank's shards over ``data``
and counts whole leaves once, so every rank clips alike and reports the
same metrics.

A ``model`` extent above 1 adds tensor parallelism (JAX's step under a mesh
with ``tp``): the aggregator's blocks (the ViT's, frame, reloc, global) hold
their model-local parts at rest (``parallel/sharding.py``'s per-head cut,
FSDP's cut applied to that part) and run Megatron's body; the patch
embedding, tokens and heads are whole on every model rank. After the
backward a cut leaf's gradient is summed over data x context (each model
rank holds its own part), a leaf read inside a column-parallel branch
(LN1, the qk-norms, LN2) over ``model`` as well (each model rank holds a
part of it), and every other leaf over data x context alone (each model
rank holds all of it). The gradient norm counts a cut leaf's parts once
across ``model`` and a replicated leaf once (``optax.global_norm`` of the
whole tree), and Adam runs on the rank-local leaves.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

import contextlib

import torch.distributed as dist

from ..heads.camera import camera_head
from ..models import sailrecon as M
from ..models.aggregator import aggregator_forward, block_cfgs, draw_subsample_indices
from ..ops import geometry as G
from ..parallel import sharding as Sh
from ..parallel import sp_block as SP
from .loss import LossConfig, scene_loss

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
B1, B2, EPS = 0.9, 0.999, 1e-8
# the subtrees the loss reaches; the DPT heads are not among them
_TRAINED = ("aggregator", "camera_head")
_BATCH_KEYS = (
    "images", "K_prime_to_K", "src_idx", "dst_idx", "src_coords",
    "dst_coords", "src_depth", "dst_depth", "pair_valid",
)


@dataclass(frozen=True)
class TrainConfig:
    max_lr: float = 2e-4
    warmup_steps: int = 2000
    total_steps: int = 100_000
    min_lr_ratio: float = 0.01
    rank: int = 300
    num_images: int = 2  # frames per scene
    loss: LossConfig = field(default_factory=LossConfig)
    # Adam first-moment dtype ("float32" or "bfloat16")
    adam_mu_dtype: str = "float32"
    # parameters, gradients and Adam moments cut over the mesh's data axis
    # (ZeRO-3, JAX's rule); in effect only under a mesh whose data extent is
    # above 1 (or under force_single_device_spmd), as in JAX
    fsdp: bool = False
    # global-norm gradient clipping before Adam; 0 disables
    grad_clip_norm: float = 0.0


def make_schedule(cfg: TrainConfig):
    """optax's ``warmup_cosine_decay_schedule`` from 0 to ``max_lr`` and down
    to ``max_lr * min_lr_ratio``, warmup clamped to ``total_steps``, in
    float32 as optax computes it. Returns step -> learning rate (float)."""
    f32 = np.float32
    warmup = min(cfg.warmup_steps, cfg.total_steps)
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    peak = cfg.max_lr
    alpha = 0.0 if peak == 0.0 else peak * cfg.min_lr_ratio / peak

    def schedule(step: int) -> float:
        if step < warmup:  # linear_schedule(0, peak, warmup)
            frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - peak) * frac + f32(peak))
        count = min(f32(step - warmup), f32(decay_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * count / f32(decay_steps)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


# -- parameter trees ------------------------------------------------------------


def _flatten(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict / list tree, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _flatten(v)]
    return [] if tree is None else [tree]


def _unflatten(tree, leaves):
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return None if node is None else next(it)

    return walk(tree)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(t.float().pow(2).sum() for t in tensors))


def clip_by_global_norm(leaves: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the leaves as they are when their global
    norm is below ``max_norm``, else each ``(g / norm) * max_norm``."""
    norm = global_norm(leaves) if norm is None else norm
    if float(norm) < max_norm:
        return leaves
    return [(g / norm) * max_norm for g in leaves]


@dataclass(frozen=True, eq=False)
class StateLayout:
    """How a train state lies over a mesh. ``specs`` mirrors the params tree
    (the Adam moments mirror it too), one spec a leaf: FSDP's leaves are cut
    over ``data`` on one dim, the others (and every leaf without ``fsdp``)
    are whole on every rank; with ``tp`` the aggregator's block leaves
    that Megatron cuts are cut over ``model`` first."""

    mesh: Sh.Mesh
    specs: Any
    fsdp: bool
    shapes: Any  # the whole leaves' shapes, a tree as ``specs``
    tp: bool = False

    def shard(self, tree):
        """This rank's slice of each leaf of a tree of whole leaves."""
        return Sh.shard_tree(tree, self.specs, self.mesh)

    def gather(self, tree, to_rank: Optional[int] = None, device=None):
        """Each leaf of a tree of this rank's slices whole (every rank calls;
        see ``sharding.gather_tree``)."""
        return Sh.gather_tree(tree, self.specs, self.mesh, to_rank, device)


def param_shapes(model_cfg: M.SailReconConfig):
    """The params tree of ``model_cfg`` on the meta device: shapes alone."""
    return M.init_sailrecon(model_cfg, None, "meta")


def state_layout(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                 mesh: Optional[Sh.Mesh] = None) -> Optional[StateLayout]:
    """The train state's layout under ``mesh`` (default: the active one), or
    None without a mesh. FSDP only with ``train_cfg.fsdp`` and a data
    extent above 1, as JAX's step has it, or under
    ``force_single_device_spmd`` (whole-leaf shards at a data extent of 1,
    the validation hook of a single card)."""
    mesh = mesh if mesh is not None else Sh.active_mesh()
    if mesh is None:
        return None
    forced = SP._FORCE_SINGLE_DEVICE_SPMD
    fsdp = train_cfg.fsdp and (mesh.shape[Sh.DATA_AXIS] > 1 or forced)
    tp = SP.tp_engaged(block_cfgs(model_cfg.aggregator), mesh)
    whole = param_shapes(model_cfg)
    specs = layout_specs(mesh, whole, fsdp, tp, forced)
    return StateLayout(mesh, specs, fsdp, _unflatten(whole, [t.shape for t in _flatten(whole)]),
                       tp)


def layout_specs(mesh, whole, fsdp: bool, tp: bool, forced: bool = False):
    """The specs of a params tree: JAX's rule (``Sh.param_sharding``), with
    the ``model`` cut on the aggregator's block leaves alone under ``tp``
    (the heads and camera tokens run replicated on every model rank)."""
    ext = Sh._extents(mesh)
    nd = ext.get(Sh.DATA_AXIS, 1) if fsdp else 1
    nm = ext.get(Sh.MODEL_AXIS, 1) if tp else 1

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if node is None:
            return None
        cut = SP.tp_block_leaf(path) is not None
        return Sh.leaf_spec(path, node.shape, nd, nm if cut else 1,
                            forced and fsdp)

    return walk(whole, ())


def _paths(tree, path=()) -> List[tuple]:
    """The path of each leaf of ``tree``, in :func:`_flatten`'s order."""
    if isinstance(tree, dict):
        return [q for k in tree for q in _paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree) for q in _paths(v, path + (i,))]
    return [] if tree is None else [path]


def state_bytes_per_rank(model_cfg: M.SailReconConfig, n: int, fsdp: bool,
                         mu_dtype: str = "float32", m: int = 1) -> int:
    """Bytes of one rank's train state (fp32 params, ``mu_dtype`` mu, fp32
    nu) at a data extent of ``n`` and a model extent of ``m``: the port's
    layout (:func:`layout_specs`) on this model's leaves, each leaf's cut
    dims divided by their extents, the others whole."""
    per = 4 + _DTYPES[mu_dtype].itemsize + 4
    shapes = param_shapes(model_cfg)
    ext = {Sh.DATA_AXIS: n, Sh.MODEL_AXIS: m}
    tp = m > 1 and SP.tp_blocks_divide(block_cfgs(model_cfg.aggregator), m)
    specs = Sh.spec_leaves(layout_specs(ext, shapes, fsdp, tp))
    return sum(int(np.prod(Sh.local_shape(t.shape, s, ext))) * per
               for t, s in zip(_flatten(shapes), specs))


def _shard_in_place(tree, specs, mesh: Sh.Mesh, path=()):
    """Each whole leaf of ``tree`` replaced by this rank's slice, one at a
    time, so that the whole leaves can be freed as the walk goes."""
    for k in (tree.keys() if isinstance(tree, dict) else range(len(tree))):
        node = tree[k]
        if isinstance(node, (dict, list)):
            _shard_in_place(node, specs[k], mesh, path + (k,))
        elif node is not None:
            tree[k] = Sh.shard_of(node, specs[k], mesh, Sh.model_groups(path + (k,)))
    return tree


def train_state_from_params(params, train_cfg: TrainConfig,
                            layout: Optional[StateLayout] = None) -> Dict[str, Any]:
    """A fresh state around ``params``: zero moments, count and step 0.
    With a ``layout``, each leaf of ``params`` (whole) is replaced in place
    by this rank's slice first, and the moments are made on the slices."""
    if layout is not None:
        params = _shard_in_place(params, layout.specs, layout.mesh)
    mu_dtype = _DTYPES[train_cfg.adam_mu_dtype]
    zeros = lambda dt: _unflatten(params, [  # noqa: E731
        torch.zeros_like(t, dtype=dt) for t in _flatten(params)])
    return {"params": params,
            "opt": {"mu": zeros(mu_dtype), "nu": zeros(torch.float32), "count": 0},
            "step": 0}


def init_train_state(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                     generator: torch.Generator, device="cuda") -> Dict[str, Any]:
    """Random fp32 params from ``generator`` (on ``device``) and a fresh state."""
    return train_state_from_params(M.init_sailrecon(model_cfg, generator, device),
                                   train_cfg)


def init_train_state_sharded(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                             generator: torch.Generator, mesh: Sh.Mesh, fsdp: bool = True,
                             device="cuda") -> Dict[str, Any]:
    """:func:`init_train_state`'s params, from the same generator, as this
    rank's slices under the mesh's layout (``fsdp`` in place of
    ``train_cfg.fsdp``). Each whole leaf is cut as soon as the walk reaches
    it; the Adam moments exist only as slices, so the whole state never
    sits on the device (the params once, transiently, as ``init_sailrecon``
    draws them: 5.97 GB at full width, against the whole state's 14.93)."""
    from dataclasses import replace

    layout = state_layout(model_cfg, replace(train_cfg, fsdp=fsdp), mesh)
    return train_state_from_params(M.init_sailrecon(model_cfg, generator, device),
                                   train_cfg, layout)


# -- loss and gradients ---------------------------------------------------------


def _loss_fn(params, model_cfg: M.SailReconConfig, train_cfg: TrainConfig, batch,
             subsample_indices=None, generator=None) -> Tuple[torch.Tensor, Dict]:
    """Mean scene loss over the batch, and the mean of each metric.

    Trunk + camera head on the duplicated layout; the bf16 trunk weights
    are cast from the fp32 masters once here, inside the graph. The scenes
    are a Python loop (JAX vmaps them)."""
    images = batch["images"]  # (B, S, H, W, 3)
    B, S, H, W = images.shape[:4]
    dup = torch.cat([images, images], dim=1)
    p = M.cast_trunk_weights(params, model_cfg)
    taps, _, cam_tok = aggregator_forward(
        p["aggregator"], model_cfg.aggregator, dup, S, S, train_cfg.rank, generator,
        subsample_indices, images_duplicated=True)
    cam_maps = camera_head(p["camera_head"], taps[-1], cam_tok, model_cfg.camera)
    extrinsic, intrinsic = G.pose_encoding_to_extri_intri(cam_maps[-1], (H, W))
    return _mean_scene_loss(extrinsic, intrinsic, batch, train_cfg)


def _mean_scene_loss(extrinsic, intrinsic, batch, train_cfg: TrainConfig):
    """The mean of the scenes' losses and of each metric."""
    losses, per_scene = [], []
    for b in range(extrinsic.shape[0]):
        scene = {k: batch[k][b] for k in _BATCH_KEYS if k != "images"}
        loss, metrics = scene_loss(extrinsic[b], intrinsic[b], scene, train_cfg.loss)
        losses.append(loss)
        per_scene.append(metrics)
    metrics = {k: torch.stack([m[k] for m in per_scene]).mean() for k in per_scene[0]}
    return torch.stack(losses).mean(), metrics


def _sharded_loss_fn(params, model_cfg: M.SailReconConfig, train_cfg: TrainConfig, images,
                     batch, idx, shard: SP.SceneShard):
    """:func:`_loss_fn` under a shard: ``images`` (B/nd, S, H, W, 3) are this
    data rank's scenes and ``idx`` their subsample; ``batch`` holds every
    scene's loss inputs. The trunk and the camera head run on the rank's
    frames; the pose encodings of every query are gathered whole (the
    gradient of a gather is the rank's own slice), and every rank computes
    the global mean loss alike."""
    S, H, W = images.shape[1:4]
    dup = torch.cat([images, images], dim=1)
    p = M.cast_trunk_weights(params, model_cfg)
    taps, _, cam_tok = aggregator_forward(
        p["aggregator"], model_cfg.aggregator, dup, S, S, train_cfg.rank, None, idx,
        images_duplicated=True, shard=shard)
    with Sh.activate_mesh(None):
        cam_maps = camera_head(p["camera_head"], taps[-1], cam_tok, model_cfg.camera)
        enc = shard.gather_all(cam_maps[-1])
        extrinsic, intrinsic = G.pose_encoding_to_extri_intri(enc, (H, W))
        return _mean_scene_loss(extrinsic, intrinsic, batch, train_cfg)


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The step's entries of a ``stack_scenes`` batch (numpy or tensors) as
    tensors on ``device``: images and geometry in fp32, indices as int64."""
    out = {}
    for k in _BATCH_KEYS:
        t = torch.as_tensor(np.asarray(batch[k]) if not torch.is_tensor(batch[k])
                            else batch[k])
        out[k] = t.to(device, torch.int64 if k in ("src_idx", "dst_idx") else
                      (torch.float32 if t.is_floating_point() else t.dtype))
    return out


def loss_and_grads(params, model_cfg: M.SailReconConfig, train_cfg: TrainConfig, batch,
                   subsample_indices=None, generator=None):
    """(loss, metrics, grads): the gradients of the mean loss with respect to
    the trained subtrees (``aggregator``, ``camera_head``), as a tree of
    the same layout; a leaf the loss does not reach gets zeros."""
    trained = {k: params[k] for k in _TRAINED}
    leaves = [t.detach().requires_grad_() for t in _flatten(trained)]
    live = {**params, **_unflatten(trained, leaves)}
    loss, metrics = _loss_fn(live, model_cfg, train_cfg, batch, subsample_indices,
                             generator)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _unflatten(
        trained, grads)


def sharded_loss_and_grads(params, model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                           batch, layout: StateLayout, subsample_indices=None,
                           generator=None, process_local: bool = False):
    """:func:`loss_and_grads` under ``layout``'s mesh, which must be active:
    (loss, metrics, grads) with each gradient summed over the mesh and laid
    out as its parameter is (this rank's slice of an FSDP leaf, else
    whole). ``batch``: every scene on every rank, or with ``process_local``
    this data rank's scenes alone (their loss inputs are then gathered over
    ``data``). ``subsample_indices`` (depth, B, S, rank) cover every scene;
    with a ``generator`` every rank draws the same whole tensor.

    Where the scenes or the frames do not divide the mesh (JAX's fallback),
    every rank runs every scene and holds the whole gradient already."""
    mesh = layout.mesh
    nd, di = mesh.shape[Sh.DATA_AXIS], mesh.index(Sh.DATA_AXIS)
    acfg = model_cfg.aggregator
    images = batch["images"]
    Bl, S, H, W = images.shape[:4]
    B = Bl * nd if process_local else Bl
    shard = SP.scene_shard(B, S, S, train_step=True, tp=layout.tp)
    if layout.tp and shard is None:
        raise ValueError(
            f"{B} scenes of {S} frames do not divide the mesh {mesh.shape}: the "
            "tensor-parallel layout needs the sharded step")
    if shard is None and process_local:
        raise ValueError(
            f"{B} scenes of {S} frames do not divide the mesh {mesh.shape}: a process-local "
            "batch needs the sharded layout")
    if process_local:
        group = mesh.group(Sh.DATA_AXIS)
        batch = {k: (v if k == "images" else Sh._all_gather(v, group, 0))
                 for k, v in batch.items()}
    elif shard is not None:
        images = images.narrow(0, di * (B // nd), B // nd)
    if subsample_indices is None and generator is not None:
        P0 = (H // acfg.patch_size) * (W // acfg.patch_size)
        subsample_indices = draw_subsample_indices(acfg, B, S, P0, min(train_cfg.rank, P0),
                                                   generator)
    idx = subsample_indices
    if idx is not None:
        idx = torch.as_tensor(idx, device=images.device).long()
        if idx.shape[1] != B:
            raise ValueError(f"subsample_indices cover {idx.shape[1]} scenes, the batch {B}")
        if shard is not None:
            idx = idx.narrow(1, di * (B // nd), B // nd)

    trained = {k: params[k] for k in _TRAINED}
    specs = Sh.leaves_like(trained, layout.specs)
    paths = _paths(trained)
    masters = _flatten(trained)
    dims = [Sh.data_dim(sp) if layout.fsdp else None for sp in specs]
    cut = [i for i, d in enumerate(dims) if d is not None]
    leaves = list(masters)
    if cut:
        # FSDP: each rank casts its trunk slices to the compute dtype, then
        # the slices are gathered whole (bf16: half the bytes of fp32)
        cast = _flatten(M.cast_trunk_weights(trained, model_cfg))
        wholes = Sh.bucketed_all_gather([cast[i] for i in cut], [dims[i] for i in cut], mesh)
        del cast
        for i, w in zip(cut, wholes):
            leaves[i] = w
        del wholes
    leaves = [t.detach().requires_grad_() for t in leaves]
    live = {**params, **_unflatten(trained, leaves)}
    if shard is None:
        with Sh.activate_mesh(None):
            loss, metrics = _loss_fn(live, model_cfg, train_cfg, batch, idx)
    else:
        loss, metrics = _sharded_loss_fn(live, model_cfg, train_cfg, images, batch, idx, shard)
    grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    del live
    grads = [(torch.zeros_like(t, dtype=m.dtype) if g is None else g.to(m.dtype))
             for t, m, g in zip(leaves, masters, grads)]
    del leaves
    whole = [i for i in range(len(grads)) if dims[i] is None]
    if shard is None:  # every rank holds the whole gradient: keep its slices
        for i in cut:
            grads[i] = Sh.shard_of(grads[i], specs[i], mesh)
    else:
        def take(idx):  # the collectives free each gradient as they copy it
            out = [grads[i] for i in idx]
            for i in idx:
                grads[i] = None
            return out

        both = (Sh.DATA_AXIS, Sh.CONTEXT_AXIS)
        for i, g in zip(whole, Sh.bucketed_all_reduce(take(whole), mesh, both)):
            grads[i] = g
        if cut:
            red = Sh.bucketed_reduce_scatter(take(cut), [dims[i] for i in cut], mesh)
            red = Sh.bucketed_all_reduce(red, mesh, Sh.CONTEXT_AXIS)
            for i, g in zip(cut, red):
                grads[i] = g
        if layout.tp:
            # the leaves read inside a column-parallel branch: each model rank
            # holds a part of their gradient
            subs = [SP.tp_block_leaf(q) for q in paths]
            branch = [i for i, q in enumerate(subs) if q is not None and SP.tp_in_branch(q)]
            for i, g in zip(branch, Sh.bucketed_all_reduce(take(branch), mesh, Sh.MODEL_AXIS)):
                grads[i] = g
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, _unflatten(
        trained, grads)


def _grad_norms(grads, layout: Optional[StateLayout] = None) -> Dict[str, torch.Tensor]:
    """``grad_norm`` and the per-subsystem norms of the (reduced) gradients:
    each leaf's sum of squares, summed over ``data`` for FSDP's slices and
    over ``model`` for Megatron's parts (a leaf whole on those ranks counted
    once), then added leaf by leaf in the order :func:`global_norm` adds
    them (a world of one gives its bits)."""
    sq = torch.stack([t.float().pow(2).sum() for t in _flatten(grads)])
    if layout is not None:
        mesh = layout.mesh
        specs = Sh.leaves_like(grads, layout.specs)
        for axis, on in ((Sh.DATA_AXIS, layout.fsdp), (Sh.MODEL_AXIS, layout.tp)):
            if not on:
                continue
            cut = torch.tensor([axis in s for s in specs], device=sq.device)
            if mesh.index(axis):
                sq = torch.where(cut, sq, torch.zeros_like(sq))
            Sh.collective_counts["all_reduce"] += 1
            dist.all_reduce(sq, group=mesh.group(axis))
    tree = _unflatten(grads, list(sq.unbind()))
    norm = lambda xs: torch.sqrt(sum(xs))  # noqa: E731
    agg = {k: v for k, v in tree["aggregator"].items() if k != "vit"}
    return {"grad_norm": norm(_flatten(tree)),
            "grad_norm_vit": norm(_flatten(tree["aggregator"]["vit"])),
            "grad_norm_agg": norm(_flatten(agg)),
            "grad_norm_camera": norm(_flatten(tree["camera_head"]))}


def _chunks(n: int, sizes: List[int], limit: int = 1 << 26):
    """Index ranges over n leaves holding at most ``limit`` elements each
    (or one leaf), to bound the optimizer's temporaries."""
    start, total = 0, 0
    for i, s in enumerate(sizes):
        if total and total + s > limit:
            yield range(start, i)
            start, total = i, 0
        total += s
    if start < n:
        yield range(start, n)


@torch.no_grad()
def adam_update(params: List[torch.Tensor], grads: List[torch.Tensor],
                mus: List[torch.Tensor], nus: List[torch.Tensor], count: int,
                lr: float) -> None:
    """One optax ``scale_by_adam`` + ``scale_by_learning_rate`` +
    ``apply_updates``, in place, as a jitted optax step computes it: m =
    (1-b1) g + b1 mu in fp32, with b1 rounded to mu's dtype first (JAX's
    weak typing makes optax's ``b1 * mu`` a bf16 product for a bf16 mu, so
    b1 = 0.8984375 there; XLA then keeps the product in fp32), v = (1-b2)
    g^2 + b2 nu, bias corrections in fp32 at
    ``count + 1``, u = m_hat / (sqrt(v_hat) + eps), p += -lr u, mu = m cast
    to its dtype. ``torch.optim.Adam`` cannot keep a bf16 first moment beside
    fp32 parameters."""
    f32 = np.float32
    c = f32(count + 1)
    bc1 = float(f32(1) - f32(B1) ** c)
    bc2 = float(f32(1) - f32(B2) ** c)
    for idx in _chunks(len(params), [t.numel() for t in params]):
        p = [params[i] for i in idx]
        g = [grads[i] for i in idx]
        mu = [mus[i] for i in idx]
        nu = [nus[i] for i in idx]
        m = torch._foreach_mul(g, 1 - B1)
        torch._foreach_add_(m, torch._foreach_mul(
            [t.float() for t in mu], float(torch.tensor(B1, dtype=mu[0].dtype))))
        v = torch._foreach_mul(g, g)
        torch._foreach_mul_(v, 1 - B2)
        torch._foreach_add_(v, torch._foreach_mul(nu, B2))
        torch._foreach_copy_(mu, m)
        torch._foreach_copy_(nu, v)
        torch._foreach_div_(m, bc1)
        torch._foreach_div_(v, bc2)
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, EPS)
        torch._foreach_div_(m, v)
        torch._foreach_mul_(m, -lr)
        torch._foreach_add_(p, m)
        del m, v


def make_train_step(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                    device="cuda"):
    """``step(state, batch, subsample_indices=None, generator=None,
    process_local=False) -> (state, metrics)``. The scene-token subsample
    comes from explicit patch-relative ``subsample_indices`` (depth, B, S,
    rank) or is drawn from ``generator``. Metrics: the loss and its parts,
    ``grad_norm`` and per-subsystem ``grad_norm_vit/agg/camera/depth/point``
    (of the gradients before clipping) and the ``learning_rate`` of this
    step, all 0-dim tensors, the same on every rank of a mesh. Runs on
    ``cuda`` unless ``device="cpu"``.

    Called under an active mesh, the step is :func:`sharded_loss_and_grads`
    with the state in :func:`state_layout`'s layout (made by
    :func:`init_train_state_sharded` or :func:`train_state_from_params`
    with that layout); ``process_local``: the batch holds this data rank's
    scenes alone."""
    dev = M._device(device)
    schedule = make_schedule(train_cfg)
    layouts: Dict[Sh.Mesh, StateLayout] = {}

    def step(state, batch, subsample_indices=None, generator=None, process_local=False):
        params, opt = state["params"], state["opt"]
        if params["aggregator"]["vit"]["pos_embed"].device.type != dev.type:
            raise ValueError(f"the state lives elsewhere than {dev}")
        mesh = Sh.active_mesh()
        if mesh is None:
            if process_local:
                raise ValueError("a process-local batch needs an active mesh")
            layout = None
            _, metrics, grads = loss_and_grads(
                params, model_cfg, train_cfg, batch_to_device(batch, dev),
                subsample_indices, generator)
        else:
            if mesh not in layouts:
                layouts[mesh] = state_layout(model_cfg, train_cfg, mesh)
            layout = layouts[mesh]
            _check_layout(params, layout)
            _, metrics, grads = sharded_loss_and_grads(
                params, model_cfg, train_cfg, batch_to_device(batch, dev), layout,
                subsample_indices, generator, process_local)
        g_leaves = _flatten(grads)
        metrics.update(_grad_norms(grads, layout))
        zero = torch.zeros((), device=dev)
        for head in ("depth_head", "point_head"):
            if head in params:
                metrics[f"grad_norm_{head.split('_')[0]}"] = zero
        if train_cfg.grad_clip_norm > 0:
            g_leaves = clip_by_global_norm(g_leaves, train_cfg.grad_clip_norm,
                                           metrics["grad_norm"])
        lr = schedule(state["step"])
        metrics["learning_rate"] = torch.tensor(lr, dtype=torch.float32)
        trained = lambda tree: _flatten({k: tree[k] for k in _TRAINED})  # noqa: E731
        adam_update(trained(params), g_leaves, trained(opt["mu"]), trained(opt["nu"]),
                    opt["count"], schedule(opt["count"]))
        opt["count"] += 1
        state["step"] += 1
        return state, metrics

    return step


def _check_layout(params, layout: StateLayout) -> None:
    """Raise unless every leaf of ``params`` has the shape of its slice under
    ``layout`` (a state made for another mesh, model or ``fsdp``)."""
    try:
        leaves = _flatten(params)
        ok = len(leaves) == len(Sh.spec_leaves(layout.shapes))
        for t, spec, shape in zip(leaves, Sh.leaves_like(params, layout.specs),
                                  Sh.leaves_like(params, layout.shapes)):
            ok = ok and tuple(t.shape) == Sh.local_shape(shape, spec, layout.mesh)
    except (KeyError, IndexError, TypeError):
        ok = False
    if not ok:
        raise ValueError("the train state was made for another layout (mesh, model or fsdp)")


def make_eval_forward(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                      device="cuda", layout: Optional[StateLayout] = None,
                      to_rank: Optional[int] = None):
    """``fwd(params, images, generator=None, subsample_indices=None) ->
    predictions``: the joint forward with every head on a batch of scenes
    (B, S, H, W, 3), on the train step's duplicated layout (anchors =
    queries = the frames), without gradients; the diagnostics forward of
    the trainer. Runs on ``cuda`` unless ``device="cpu"``.

    With a ``layout`` the params are a rank's state: every rank must call,
    FSDP's slices are gathered whole (the DPT heads' too, which the step
    never gathers), and the forward runs unsharded. With ``to_rank`` only
    that rank gathers the whole and runs it; the others return None."""
    dev = M._device(device)

    @torch.no_grad()
    def fwd(params, images, generator=None, subsample_indices=None):
        if layout is not None:
            if layout.fsdp or layout.tp:
                params = layout.gather(params, to_rank)
            if to_rank is not None and dist.get_rank() != to_rank:
                return None
        with Sh.activate_mesh(None) if layout is not None else contextlib.nullcontext():
            return _eval(params, images, generator, subsample_indices)

    def _eval(params, images, generator, subsample_indices):
        images = torch.as_tensor(images).to(dev, torch.float32)
        S = images.shape[1]
        return M.forward(
            M.cast_trunk_weights(params, model_cfg), model_cfg,
            torch.cat([images, images], dim=1), num_anchor=S, num_query=S,
            rank=train_cfg.rank, generator=generator,
            subsample_indices=subsample_indices, images_duplicated=True, device=dev)

    return fwd
