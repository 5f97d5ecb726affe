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
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..heads.camera import camera_head
from ..models import sailrecon as M
from ..models.aggregator import aggregator_forward
from ..ops import geometry as G
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
    # parameters and optimizer state sharded over devices: multi-device
    # training is a later slice of the port, so True raises
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


def train_state_from_params(params, train_cfg: TrainConfig) -> Dict[str, Any]:
    """A fresh state around ``params``: zero moments, count and step 0."""
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
    losses, per_scene = [], []
    for b in range(B):
        scene = {k: batch[k][b] for k in _BATCH_KEYS if k != "images"}
        loss, metrics = scene_loss(extrinsic[b], intrinsic[b], scene, train_cfg.loss)
        losses.append(loss)
        per_scene.append(metrics)
    metrics = {k: torch.stack([m[k] for m in per_scene]).mean() for k in per_scene[0]}
    return torch.stack(losses).mean(), metrics


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
    """``step(state, batch, subsample_indices=None, generator=None) ->
    (state, metrics)``. The scene-token subsample comes from explicit
    patch-relative ``subsample_indices`` (depth, B, S, rank) or is drawn
    from ``generator``. Metrics: the loss and its parts, ``grad_norm`` and
    per-subsystem ``grad_norm_vit/agg/camera/depth/point`` (of the gradients
    before clipping) and the ``learning_rate`` of this step, all 0-dim
    tensors. Runs on ``cuda`` unless ``device="cpu"``."""
    dev = M._device(device)
    if train_cfg.fsdp:
        raise NotImplementedError("sharded (fsdp) training is not ported yet")
    schedule = make_schedule(train_cfg)

    def step(state, batch, subsample_indices=None, generator=None):
        params, opt = state["params"], state["opt"]
        if params["aggregator"]["vit"]["pos_embed"].device.type != dev.type:
            raise ValueError(f"the state lives elsewhere than {dev}")
        _, metrics, grads = loss_and_grads(
            params, model_cfg, train_cfg, batch_to_device(batch, dev),
            subsample_indices, generator)
        g_leaves = _flatten(grads)
        zero = torch.zeros((), device=dev)
        agg = {k: v for k, v in grads["aggregator"].items() if k != "vit"}
        metrics["grad_norm"] = global_norm(g_leaves)
        metrics["grad_norm_vit"] = global_norm(_flatten(grads["aggregator"]["vit"]))
        metrics["grad_norm_agg"] = global_norm(_flatten(agg))
        metrics["grad_norm_camera"] = global_norm(_flatten(grads["camera_head"]))
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


def make_eval_forward(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                      device="cuda"):
    """``fwd(params, images, generator=None, subsample_indices=None) ->
    predictions``: the joint forward with every head on a batch of scenes
    (B, S, H, W, 3), on the train step's duplicated layout (anchors =
    queries = the frames), without gradients; the diagnostics forward of
    the trainer. Runs on ``cuda`` unless ``device="cpu"``."""
    dev = M._device(device)

    @torch.no_grad()
    def fwd(params, images, generator=None, subsample_indices=None):
        images = torch.as_tensor(images).to(dev, torch.float32)
        S = images.shape[1]
        return M.forward(
            M.cast_trunk_weights(params, model_cfg), model_cfg,
            torch.cat([images, images], dim=1), num_anchor=S, num_query=S,
            rank=train_cfg.rank, generator=generator,
            subsample_indices=subsample_indices, images_duplicated=True, device=dev)

    return fwd
