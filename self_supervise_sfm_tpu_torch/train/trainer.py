"""Self-supervised trainer: the scene stream, checkpoints and resume,
validation and diagnostics around the train step, on one device.

Port of ``self_supervise_sfm_tpu/train/trainer.py``:

- a background thread loads and stacks scenes into a bounded queue; slot
  ``s`` of step ``t`` draws from an rng seeded by ``(seed, t, s)``, so the
  port streams the batches the JAX trainer streams. Batches go to the card
  from pinned memory;
- checkpoints carry the whole train state, and a run resumes from the
  latest one in ``<results_dir>/checkpoints``. The step's scene-token
  subsample depends on ``(seed, step)`` alone (:func:`step_subsample`), so a
  resumed run repeats the uninterrupted one without a saved generator;
- every-N-step diagnostics: the reprojection sanity check, and artifact
  dumps (PLY point cloud, KITTI poses, CDF / PDF curves, overlays), one
  diagnostics forward shared by both;
- held-out validation with a best checkpoint and early stopping
  (``validate.py``), a SIGTERM / SIGINT handler that checkpoints at the next
  step edge, a CDF-range curriculum and a ``torch.profiler`` window.

Under a process group (torchrun's environment, :func:`maybe_init_distributed`,
or one the caller started) the trainer runs one rank a process over a
(data, context, model) mesh, ``num_data = world // (num_context *
num_model)``, as JAX's trainer builds its mesh (``model`` innermost, so a
model group is adjacent ranks): each data rank loads only its own scenes
(``scenes_per_step_per_device`` slots a step, its context and model ranks
the same ones), the step is the sharded one of ``loop.py`` (DDP, or FSDP
with ``train.fsdp``, either with tensor parallelism over ``model``:
``num_model`` / ``--tp``), checkpoints hold the whole state whatever the
mesh, and
only rank 0 writes metrics, artifacts and the profile. Every rank runs
validation (deterministic, so the early stop agrees without a broadcast),
the checkpoint collectives and the gathers of the diagnostics forward.
``pretrained``
starts from a reference SAIL-Recon state dict through
``utils/converter.py``. The trainer runs on ``cuda`` unless
``device="cpu"``; the process group is NCCL on the card and gloo on the
CPU.

Run:  python -m self_supervise_sfm_tpu_torch.train.trainer --data-root ... [--steps N]
      torchrun --nproc_per_node N -m self_supervise_sfm_tpu_torch.train.trainer --fsdp ...
      torchrun --nproc_per_node N -m self_supervise_sfm_tpu_torch.train.trainer --tp M ...
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import signal
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator

import numpy as np
import torch
import torch.distributed as dist

from ..models import sailrecon as M
from ..parallel import sharding as Sh
from . import loop as L
from .checkpoint import CheckpointManager
from .loss import LossConfig
from .metrics import MetricsWriter
from .validate import BestTracker, EvalConfig, load_scenes, make_validator

# the diagnostics forward's outputs that the sanity check and artifacts read
_DIAG_KEYS = ("extrinsic", "intrinsic", "point_map", "xyz_cnf")


@dataclass(frozen=True)
class TrainerConfig:
    # a directory of IMC2021-format scenes, or any object with ``__len__``
    # and ``load_scene(idx, rng)``
    data_root: Any = ""
    results_dir: str = "results"
    total_steps: int = 100_000
    num_images: int = 2
    sample_num: int = 10_000
    scenes_per_step_per_device: int = 1
    num_context: int = 1
    num_model: int = 1
    prefetch: int = 4
    seed: int = 0
    checkpoint_every: int = 10_000
    artifact_every: int = 10_000
    sanity_check_every: int = 500
    log_every: int = 10
    compute_dtype: str = "bfloat16"
    remat: bool = True
    rank: int = 300
    # model size (ViT-L/24 by default; smaller for ablations and CPU runs)
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    vit_depth: int = 24
    pretrained: str = ""  # a PyTorch sailrecon.pt to convert and load
    # a checkpoint directory to seed the params from, with a fresh
    # optimizer, schedule and step (a results-dir resume restores the whole
    # state instead): the coarse-to-fine hand-off, the ViT pos embed
    # resampled to this run's img_size
    init_params_from: str = ""
    # comma-separated top-level param subtrees (e.g. "camera_head") drawn
    # afresh when seeding from init_params_from
    reinit_subtrees: str = ""
    img_size: int = 518
    # torch.profiler window: steps [profile_start, profile_start +
    # profile_steps) into <results_dir>/profile; 0 disables
    profile_start: int = 0
    profile_steps: int = 0
    # CDF-range curriculum: steps AFTER loss_switch_step train with
    # loss.max_val = loss_max_val_final (0 disables). Far from a pretrained
    # init the histogram needs a wide range (residuals past max_val give
    # CDF 2.0 and no gradient); once residuals shrink, the range tightens
    loss_max_val_final: float = 0.0
    loss_switch_step: int = 0
    # data plane: None = the C++ loader when it builds, False = Python / PIL
    native_loader: "bool | None" = None
    # held-out validation and early stopping (validate.py)
    eval_every: int = 0
    eval_data_root: Any = ""
    eval_num_images: int = 8
    eval_sample_num: int = 2048
    eval_heldout_from: int = 0
    eval_min_delta: float = 0.0
    early_stop_patience: int = 0
    device: str = "cuda"
    train: L.TrainConfig = field(default_factory=L.TrainConfig)


def scene_stream(ds, slots, seed: int, prefetch: int, start: int = 0) -> Iterator[dict]:
    """Background-threaded scene loader -> stacked host batches of steps
    ``start``, ``start + 1``, ...

    ``ds``: anything with ``__len__`` and ``load_scene(idx, rng)``. Slot
    ``s`` of step ``t`` draws from an rng seeded by ``(seed, t, s)``, so a
    run resumed at step ``start`` gets the batches the uninterrupted run
    got there. An error in the loader thread is raised here, by the
    consumer."""
    from ..data.imc2021 import stack_scenes

    slots = list(slots)
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> None:
        # a bounded put that re-checks stop: a bare put blocks forever on a
        # full queue once the consumer is gone
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return
            except queue.Full:
                pass

    def worker():
        t = start
        try:
            while not stop.is_set():
                scenes = []
                for s in slots:
                    rng = np.random.default_rng(np.random.SeedSequence((seed, t, s)))
                    idx = int(rng.integers(len(ds)))
                    scenes.append(ds.load_scene(idx, rng))
                put(stack_scenes(scenes))
                t += 1
        except Exception as e:  # handed to the consumer, which raises it
            put(e)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, Exception):
                raise RuntimeError("the scene loader failed") from item
            yield item
    finally:
        stop.set()
        thread.join()


def step_subsample(seed: int, step: int, device) -> Dict[str, Any]:
    """The scene-token subsample of train step ``step`` and of the
    diagnostics forward at ``step``: a generator on ``device`` seeded from
    ``(seed, step)`` alone, made afresh for each step, as keyword arguments
    of the step and of the eval forward."""
    s = np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]
    return {"generator": torch.Generator(device=device).manual_seed(int(s))}


def batch_to_device(host_batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """The step's entries of a host batch on ``device``; to a card through
    pinned memory, asynchronously."""
    out = {}
    for k in L._BATCH_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(host_batch[k]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return L.batch_to_device(out, device)


def _host_scalars(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Every metric as a float, those on the device in one transfer."""
    host = {k: float(v) for k, v in metrics.items() if v.device.type == "cpu"}
    on_dev = [k for k in metrics if k not in host]
    if on_dev:
        host.update(zip(on_dev, torch.stack([metrics[k].float() for k in on_dev]).tolist()))
    return {k: host[k] for k in metrics}


def dump_artifacts(step, preds, tcfg, batch, results_dir):
    """Every-N-step artifact dumps: PLY point cloud, KITTI poses, per-frame
    CDF / PDF curves, the correspondence overlay and the bidirectional
    reprojection grid of scene 0. ``preds``: host (numpy) predictions of
    scene 0, from the diagnostics forward the sanity check shares."""
    from ..utils import export as EX
    from ..utils.sanity_check import sanity_check_relative_poses
    from ..utils.vls import plot_cdf_pdf_curves, reprojection_validation_grid
    from .loss import scene_cdf_statistics

    out_dir = os.path.join(results_dir, "vls", f"step_{step}")
    os.makedirs(out_dir, exist_ok=True)
    S = batch["images"].shape[1]
    per_view = [{"point_map": preds["point_map"][0, i], "xyz_cnf": preds["xyz_cnf"][0, i],
                 "images": batch["images"][0, i]} for i in range(S)]
    EX.save_pointcloud_ply(per_view, os.path.join(out_dir, "pred.ply"))
    EX.save_kitti_poses(preds["extrinsic"][0], os.path.join(out_dir, "poses_kitti.txt"))
    scene0 = {k: np.asarray(v[0]) for k, v in batch.items() if isinstance(v, np.ndarray)}
    lcfg = tcfg.loss
    stats = scene_cdf_statistics(
        torch.from_numpy(preds["extrinsic"][0]), torch.from_numpy(preds["intrinsic"][0]),
        {k: torch.from_numpy(v) for k, v in scene0.items()}, lcfg)
    for name in ("exact", "approx"):
        plot_cdf_pdf_curves(
            stats[name]["frame_cdf"].numpy(), stats[name]["frame_pdf"].numpy(),
            lcfg.min_val, lcfg.max_val, lcfg.num_bins,
            os.path.join(out_dir, f"cdf_pdf_{name}.png"))
    m = sanity_check_relative_poses(
        preds["extrinsic"][0], preds["intrinsic"][0], scene0,
        save_path=os.path.join(out_dir, "sanity_overlay.png"))
    reprojection_validation_grid(
        scene0, preds["extrinsic"][0], preds["intrinsic"][0],
        save_path=os.path.join(out_dir, "reproj_grid.png"))
    return m


def _model_config(cfg: TrainerConfig) -> M.SailReconConfig:
    model_kw = {}
    if cfg.depth != 24:
        # the DPT heads need exactly 4 tap layers; spread them over the depth
        if cfg.depth < 4:
            raise ValueError("model depth must be >= 4 (4 DPT tap layers)")
        model_kw["intermediate_layer_idx"] = tuple(
            round((i + 1) * cfg.depth / 4) - 1 for i in range(4))
    return M.make_config(
        img_size=cfg.img_size, compute_dtype=cfg.compute_dtype, remat=cfg.remat,
        embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
        vit_depth=cfg.vit_depth, **model_kw)


def _seeded_params(cfg: TrainerConfig, model_cfg, dev):
    """The params of ``init_params_from``'s latest checkpoint on ``dev``,
    the ViT pos embed resampled to this run's grid and the
    ``reinit_subtrees`` drawn afresh."""
    from ..layers.vit import resample_pos_embed

    print(f"seeding params from checkpoint: {cfg.init_params_from}")
    prev = CheckpointManager(cfg.init_params_from).restore()
    if prev is None:
        raise FileNotFoundError(f"no checkpoint under {cfg.init_params_from}")
    params = L._unflatten(prev["params"], [t.to(dev) for t in L._flatten(prev["params"])])
    del prev
    vit = params["aggregator"]["vit"]
    target_grid = cfg.img_size // model_cfg.aggregator.vit.patch_size
    if vit["pos_embed"].shape[1] != target_grid * target_grid + 1:
        print(f"resampling ViT pos embed {vit['pos_embed'].shape[1] - 1} -> "
              f"{target_grid * target_grid} patch tokens")
        vit["pos_embed"] = resample_pos_embed(vit["pos_embed"], target_grid)
    names = [n.strip() for n in cfg.reinit_subtrees.split(",") if n.strip()]
    if names:
        unknown = [n for n in names if n not in params]
        if unknown:
            raise ValueError(f"--reinit-subtrees names not in params: {unknown} "
                             f"(have {sorted(params)})")
        s = np.random.SeedSequence((cfg.seed, 0xC0)).generate_state(1, np.uint64)[0]
        fresh = M.init_sailrecon(model_cfg, torch.Generator(device=dev).manual_seed(int(s)),
                                 dev)
        for n in names:
            print(f"re-initializing param subtree: {n}")
            params[n] = fresh[n]
    return params


def maybe_init_distributed(device="cuda") -> None:
    """Start the default process group under torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``): NCCL with the card ``LOCAL_RANK``, or gloo when
    ``device`` is the CPU (the reference's rendezvous,
    ``train_imc.py:47-58``). Outside torchrun, or with a group started
    already, it does nothing."""
    if dist.is_initialized() or "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    print(f"distributed: rank {dist.get_rank()} of {dist.get_world_size()}")


def _make_mesh(cfg: TrainerConfig, dev: torch.device):
    """The (data, context, model) mesh over the world of the process group,
    or None without one (the one-device trainer)."""
    inner = cfg.num_context * cfg.num_model
    if not dist.is_initialized():
        if inner > 1:
            raise ValueError(
                f"multi-device training with num_context={cfg.num_context}, "
                f"num_model={cfg.num_model} needs {inner} ranks at least: start it under "
                f"torchrun --nproc_per_node N (N a multiple of {inner})")
        return None
    world = dist.get_world_size()
    if world % inner:
        raise ValueError(f"multi-device training: a world of {world} ranks does not split "
                         f"into context x model groups of {cfg.num_context} x "
                         f"{cfg.num_model}")
    mesh = Sh.make_mesh(world // inner, cfg.num_context, cfg.num_model, device=dev)
    if cfg.num_images % cfg.num_context:
        raise ValueError(f"multi-device training: {cfg.num_images} frames a scene do not "
                         f"split over a context extent of {cfg.num_context}")
    print(f"mesh: data={mesh.shape['data']} context={mesh.shape['context']} "
          f"model={mesh.shape['model']} ({dev.type}, {dist.get_backend()})")
    return mesh


def _any_rank(flag: bool, mesh, dev) -> bool:
    """Whether ``flag`` is set on any rank of the mesh (a signal reaches the
    ranks at different steps; they must stop at the same one)."""
    if mesh is None or mesh.size(("data", "context", "model")) == 1:
        return flag
    t = torch.tensor([int(flag)], device=dev)
    for axes in (("data", "context"), "model"):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return bool(t.item())


def run(cfg: TrainerConfig):
    maybe_init_distributed(cfg.device)
    dev = M._device(cfg.device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = _make_mesh(cfg, dev)
    primary = not dist.is_initialized() or dist.get_rank() == 0
    os.makedirs(cfg.results_dir, exist_ok=True)
    print(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                              if dev.type == "cuda" else ""))
    model_cfg = _model_config(cfg)
    tcfg = replace(cfg.train, total_steps=cfg.total_steps, rank=cfg.rank,
                   num_images=cfg.num_images)
    if bool(cfg.loss_switch_step) != bool(cfg.loss_max_val_final):
        # a half-configured curriculum would otherwise be silently ignored
        raise ValueError(
            "CDF-range curriculum needs BOTH --loss-switch-step and "
            f"--loss-max-val-final (got switch_step={cfg.loss_switch_step}, "
            f"max_val_final={cfg.loss_max_val_final}); set both or neither")
    if cfg.loss_switch_step and cfg.loss_switch_step >= cfg.total_steps:
        raise ValueError("loss_switch_step must be < total_steps or the curriculum "
                         "never engages (steps AFTER the switch use the final range)")

    layout = L.state_layout(model_cfg, tcfg, mesh) if mesh is not None else None
    ckpt = CheckpointManager(os.path.join(cfg.results_dir, "checkpoints"))
    if cfg.pretrained:
        from ..utils import converter as C

        print(f"loading pretrained torch checkpoint: {cfg.pretrained}")
        params = C.convert_sailrecon(C.load_torch_state_dict(cfg.pretrained),
                                     model_cfg.aggregator.depth,
                                     model_cfg.aggregator.vit.depth)
        params = L._unflatten(params, [t.to(dev) for t in L._flatten(params)])
        state = L.train_state_from_params(params, tcfg, layout)
    elif cfg.init_params_from:
        state = L.train_state_from_params(_seeded_params(cfg, model_cfg, dev), tcfg, layout)
    elif layout is not None and (layout.fsdp or layout.tp):
        state = L.init_train_state_sharded(
            model_cfg, tcfg, torch.Generator(device=dev).manual_seed(cfg.seed), mesh,
            fsdp=tcfg.fsdp, device=dev)
    else:
        state = L.init_train_state(
            model_cfg, tcfg, torch.Generator(device=dev).manual_seed(cfg.seed), dev)
    if ckpt.latest_step() is not None:
        print(f"resuming from step {ckpt.latest_step()}")
        state = ckpt.restore(template=state, layout=layout)

    ds = load_scenes(cfg.data_root, cfg.sample_num, cfg.num_images, cfg.img_size,
                     use_native=cfg.native_loader)
    print(f"dataset: {len(ds)} scenes ({type(ds).__name__}, "
          f"native_loader={getattr(ds, 'use_native', None)})")
    # each data rank loads its own block of the step's scene slots (its
    # context ranks the same block); the stream starts at the resumed step
    # (the JAX trainer's starts at 0 whatever the step, so its resumed run
    # sees other batches)
    spd = cfg.scenes_per_step_per_device
    data_index = mesh.index("data") if mesh is not None else 0
    process_local = mesh is not None and mesh.shape["data"] > 1
    batches = scene_stream(ds, range(data_index * spd, (data_index + 1) * spd), cfg.seed,
                           cfg.prefetch, start=state["step"])
    writer = MetricsWriter(os.path.join(cfg.results_dir, "tensorboard") if primary else None,
                           console_every=cfg.log_every if primary else 0)
    ecfg = EvalConfig(
        data_root=cfg.eval_data_root, every=cfg.eval_every,
        num_images=cfg.eval_num_images, sample_num=cfg.eval_sample_num,
        heldout_from=cfg.eval_heldout_from, patience=cfg.early_stop_patience,
        min_delta=cfg.eval_min_delta)
    validator = best_ckpt = None
    tracker = BestTracker(ecfg.patience, ecfg.min_delta)
    if ecfg.enabled:
        validator = make_validator(model_cfg, tcfg, ecfg, cfg.img_size, dev)
        if cfg.checkpoint_every:
            best_ckpt = CheckpointManager(
                os.path.join(cfg.results_dir, "checkpoints_best"), max_to_keep=1)

    # preemption: the handler only sets a flag; the loop checkpoints at the
    # next step edge and exits
    preempted = threading.Event()

    def _on_preempt(signum, frame):
        print(f"signal {signum}: checkpointing at next step edge", flush=True)
        preempted.set()

    prev_handlers = {}
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _on_preempt)

    step_fn = L.make_train_step(model_cfg, tcfg, dev)
    step_fn_final = None
    if cfg.loss_switch_step:
        step_fn_final = L.make_train_step(
            model_cfg, replace(tcfg, loss=replace(tcfg.loss, max_val=cfg.loss_max_val_final)),
            dev)
    eval_fwd = L.make_eval_forward(model_cfg, tcfg, dev, layout,
                                   to_rank=0 if layout is not None else None)

    def whole_params():
        """The params whole on every rank, for validation (every rank
        enters the gathers of FSDP's slices)."""
        if layout is None or not (layout.fsdp or layout.tp):
            return state["params"]
        return layout.gather(state["params"])

    step = state["step"]
    profiler = None
    last_step_time = None
    try:
        while step < cfg.total_steps and not _any_rank(preempted.is_set(), mesh, dev):
            if (cfg.profile_steps and primary and step == cfg.profile_start
                    and profiler is None):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                profiler = torch.profiler.profile(activities=acts)
                profiler.start()
            host_batch = next(batches)
            batch = batch_to_device(host_batch, dev)
            fn = (step_fn_final if step_fn_final is not None
                  and step >= cfg.loss_switch_step else step_fn)
            with Sh.activate_mesh(mesh):
                state, metrics = fn(state, batch, **step_subsample(cfg.seed, step, dev),
                                    **({"process_local": True} if process_local else {}))
            step = state["step"]
            scalars = _host_scalars(metrics)
            if profiler is not None and step >= cfg.profile_start + cfg.profile_steps:
                profiler.stop()
                os.makedirs(os.path.join(cfg.results_dir, "profile"), exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(cfg.results_dir, "profile", "trace.json"))
                profiler = None
                print(f"profile trace written to {cfg.results_dir}/profile")
            # throughput from the host clock between steps: the step's frames
            # over the mesh's ranks
            frames = batch["images"].shape[0] * batch["images"].shape[1]
            if mesh is not None:
                frames = frames * (mesh.shape["data"] if process_local else 1) / mesh.size(
                    ("data", "context"))
            now = time.perf_counter()
            if last_step_time is not None and now > last_step_time:
                scalars["frames_per_sec_per_chip"] = frames / (now - last_step_time)
                scalars["steps_per_sec"] = 1.0 / (now - last_step_time)
            last_step_time = now
            writer.write(step, scalars)
            do_sanity = bool(cfg.sanity_check_every and step % cfg.sanity_check_every == 0)
            do_artifacts = bool(cfg.artifact_every and step % cfg.artifact_every == 0)
            if do_sanity or do_artifacts:
                # one diagnostics forward, shared by the sanity check and the
                # artifact dump; under a mesh every rank enters its gathers,
                # rank 0 (whose first scene is the step's first) runs it
                out = eval_fwd(state["params"], batch["images"][:1],
                               **step_subsample(cfg.seed, step, dev))
                do_sanity, do_artifacts = do_sanity and primary, do_artifacts and primary
                if primary:
                    preds = {k: out[k].float().cpu().numpy() for k in _DIAG_KEYS}
                del out
            if do_sanity:
                from ..utils.sanity_check import sanity_check_relative_poses

                scene0 = {k: np.asarray(v[0]) for k, v in host_batch.items()
                          if isinstance(v, np.ndarray)}
                m = sanity_check_relative_poses(preds["extrinsic"][0],
                                                preds["intrinsic"][0], scene0)
                writer.write(step, {k: v for k, v in m.items() if k != "pair"},
                             prefix="sanity")
            if do_artifacts:
                dump_artifacts(step, preds, tcfg, host_batch, cfg.results_dir)
            if cfg.checkpoint_every and step % cfg.checkpoint_every == 0:
                ckpt.save(step, state, layout)
            if validator is not None and step % ecfg.every == 0:
                vm = validator(whole_params())
                improved, should_stop = tracker.update(step, vm["px_residual"])
                writer.write(step, {**vm, "best_step": float(tracker.best_step)},
                             prefix="val")
                if primary:
                    print(f"[val {step}] px_residual {vm['px_residual']:.3f} "
                          f"log {vm['log_residual']:.3f} (best {tracker.best:.3f} @ "
                          f"{tracker.best_step})" + (" *" if improved else ""), flush=True)
                if improved and best_ckpt is not None:
                    best_ckpt.save(step, state, layout)
                if should_stop:
                    print(f"early stop at step {step}: no improvement in "
                          f"{tracker.stale} validations (best {tracker.best:.4f} @ "
                          f"step {tracker.best_step})", flush=True)
                    break
        if validator is not None and primary:
            with open(os.path.join(cfg.results_dir, "best.json"), "w") as f:
                json.dump(tracker.summary(), f)
        # checkpoint_every=0 opts out of every save
        if cfg.checkpoint_every:
            ckpt.save(step, state, layout)
    finally:
        if profiler is not None:
            profiler.stop()
        batches.close()
        for mgr in (best_ckpt, ckpt):
            if mgr is not None:
                mgr.close()
        writer.close()
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
    if preempted.is_set():
        print(f"preempted: state saved at step {step}; rerun to resume")
    return state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--results-dir", default="results")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a card, cuda raises")
    ap.add_argument("--steps", type=int, default=100_000)
    ap.add_argument("--num-images", type=int, default=2)
    ap.add_argument("--sample-num", type=int, default=10_000)
    ap.add_argument("--img-size", type=int, default=518)
    ap.add_argument("--num-context", type=int, default=1,
                    help="context (sequence-parallel) extent of the mesh; the data extent "
                         "is the world over context x model")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel (model) extent of the mesh: heads and MLP hidden "
                         "units of the aggregator's blocks cut over it")
    ap.add_argument("--max-lr", type=float, default=2e-4)
    ap.add_argument("--warmup", type=int, default=2000)
    ap.add_argument("--pretrained", default="")
    ap.add_argument("--init-params-from", default="",
                    help="checkpoint dir: seed params only (fresh optimizer and "
                         "schedule); the coarse-to-fine resolution hand-off")
    ap.add_argument("--reinit-subtrees", default="",
                    help="comma-separated top-level param subtrees (e.g. camera_head) "
                         "to re-initialize when seeding via --init-params-from")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fsdp", action="store_true",
                    help="shard params, gradients and optimizer state over the mesh's "
                         "data axis (under torchrun with more than one data rank)")
    ap.add_argument("--adam-mu-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--profile-start", type=int, default=0)
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="capture a torch.profiler trace over N steps")
    ap.add_argument("--checkpoint-every", type=int, default=10_000)
    ap.add_argument("--artifact-every", type=int, default=10_000,
                    help="PLY/KITTI/CDF-PDF-curve dump interval (0 disables)")
    ap.add_argument("--sanity-check-every", type=int, default=500)
    ap.add_argument("--embed-dim", type=int, default=1024)
    ap.add_argument("--depth", type=int, default=24)
    ap.add_argument("--num-heads", type=int, default=16)
    ap.add_argument("--vit-depth", type=int, default=24)
    ap.add_argument("--rank", type=int, default=300)
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run held-out validation every N steps (needs "
                         "--eval-data-root; 0 disables)")
    ap.add_argument("--eval-data-root", default="",
                    help="directory of held-out scenes; the validation metric is "
                         "their self-supervised reprojection residual")
    ap.add_argument("--eval-num-images", type=int, default=8)
    ap.add_argument("--eval-sample-num", type=int, default=2048)
    ap.add_argument("--eval-heldout-from", type=int, default=0,
                    help="count only correspondence pairs touching frame index >= K")
    ap.add_argument("--eval-min-delta", type=float, default=0.0,
                    help="relative improvement required to count as a new best")
    ap.add_argument("--early-stop-patience", type=int, default=0,
                    help="stop after P validations without improvement (0 "
                         "disables); the best state is kept in "
                         "<results-dir>/checkpoints_best")
    ap.add_argument("--no-native-loader", action="store_true",
                    help="force the pure-python data pipeline")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection: fail at the backward op that "
                         "produced the first NaN (slow; debugging only)")
    ap.add_argument("--loss-max-val", type=float, default=15.0,
                    help="CDF histogram upper bound over log1p residuals; raise it "
                         "when training far from a pretrained init")
    ap.add_argument("--loss-max-val-final", type=float, default=0.0,
                    help="steps after --loss-switch-step train with this CDF "
                         "max_val (0 disables)")
    ap.add_argument("--loss-switch-step", type=int, default=0)
    ap.add_argument("--grad-clip-norm", type=float, default=0.0,
                    help="global-norm gradient clip (0 = off)")
    args = ap.parse_args(argv)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    cfg = TrainerConfig(
        data_root=args.data_root,
        results_dir=args.results_dir,
        total_steps=args.steps,
        num_images=args.num_images,
        sample_num=args.sample_num,
        img_size=args.img_size,
        num_context=args.num_context,
        num_model=args.tp,
        pretrained=args.pretrained,
        init_params_from=args.init_params_from,
        reinit_subtrees=args.reinit_subtrees,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        profile_start=args.profile_start,
        profile_steps=args.profile_steps,
        loss_max_val_final=args.loss_max_val_final,
        loss_switch_step=args.loss_switch_step,
        checkpoint_every=args.checkpoint_every,
        artifact_every=args.artifact_every,
        sanity_check_every=args.sanity_check_every,
        embed_dim=args.embed_dim,
        depth=args.depth,
        num_heads=args.num_heads,
        vit_depth=args.vit_depth,
        rank=args.rank,
        native_loader=False if args.no_native_loader else None,
        eval_every=args.eval_every,
        eval_data_root=args.eval_data_root,
        eval_num_images=args.eval_num_images,
        eval_sample_num=args.eval_sample_num,
        eval_heldout_from=args.eval_heldout_from,
        eval_min_delta=args.eval_min_delta,
        early_stop_patience=args.early_stop_patience,
        device=args.device,
        train=L.TrainConfig(max_lr=args.max_lr, warmup_steps=args.warmup,
                            total_steps=args.steps, loss=LossConfig(max_val=args.loss_max_val),
                            fsdp=args.fsdp, adam_mu_dtype=args.adam_mu_dtype,
                            grad_clip_norm=args.grad_clip_norm),
    )
    run(cfg)


if __name__ == "__main__":
    main()
