"""Held-out validation and early stopping for the trainer.

Port of ``self_supervise_sfm_tpu/train/validate.py``. Self-supervised
fine-tuning on one scene can overfit past an optimum; this finds it:

- ``--eval-every N --eval-data-root DIR`` runs a self-supervised validation
  every N steps: poses of held-out scenes from the forward, then the mean
  reprojection residual of their correspondences (what the loss optimises,
  on data the loss never sees; no ground-truth poses needed);
- ``--eval-heldout-from K`` counts only the correspondence pairs touching
  frame index >= K (fine-tune on a scene's first K frames, point
  ``--eval-data-root`` at the whole scene, and the metric reads the rest);
- the best score keeps a best checkpoint (``checkpoints_best/``,
  ``max_to_keep=1``);
- ``--early-stop-patience P`` stops after P validations in a row without
  improvement (``--eval-min-delta`` sets the relative gain that counts).

Determinism: the scenes load once with a fixed rng, and every validation
forward takes the same scene-token subsample (:func:`eval_subsample`), so
scores compare across steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..models import sailrecon as M
from .loop import TrainConfig, batch_to_device, make_eval_forward
from .loss import _masked_mean, scene_residuals

EVAL_SEED = 0x5EED


@dataclass(frozen=True)
class EvalConfig:
    # a directory of IMC2021-format scenes, or any object with ``__len__``
    # and ``load_scene(idx, rng)``
    data_root: Any = ""
    every: int = 0  # steps between validations (0 disables)
    num_images: int = 8  # frames per eval-scene forward
    sample_num: int = 2048  # correspondence samples per pair
    heldout_from: int = 0  # only pairs touching frame >= K count (0: all)
    patience: int = 0  # validations without improvement before stop (0: off)
    min_delta: float = 0.0  # relative improvement required to reset patience

    @property
    def enabled(self) -> bool:
        return bool(self.every) and bool(self.data_root)


class BestTracker:
    """Tracks the best validation metric and the early-stop decision."""

    def __init__(self, patience: int, min_delta: float):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.best_step = -1
        self.stale = 0

    def update(self, step: int, metric: float) -> tuple[bool, bool]:
        """Returns (improved, should_stop)."""
        # the first measurement always counts (inf times a negative factor
        # is -inf, which no finite metric beats when min_delta > 1)
        improved = (self.best_step < 0
                    or metric < self.best * (1.0 - self.min_delta))
        if improved:
            self.best = metric
            self.best_step = step
            self.stale = 0
        else:
            self.stale += 1
        should_stop = bool(self.patience) and self.stale >= self.patience
        return improved, should_stop

    def summary(self) -> dict:
        return {"best_val_px_residual": self.best, "best_step": self.best_step}


def eval_subsample(device) -> dict:
    """The scene-token subsample of every validation forward: a generator
    on ``device`` seeded with the same constant each call."""
    return {"generator": torch.Generator(device=device).manual_seed(EVAL_SEED)}


def load_scenes(data_root, sample_num: int, num_images: int, img_size: int,
                use_native=False):
    """The dataset at ``data_root``: an object with ``__len__`` and
    ``load_scene(idx, rng)`` as it is, else the IMC2021 scenes under that
    directory (``use_native`` picks the loader, as ``IMC2021Scenes``)."""
    if hasattr(data_root, "load_scene"):
        return data_root
    from ..data.imc2021 import IMC2021Scenes

    return IMC2021Scenes(data_root, sample_num=sample_num, num_images=num_images,
                         target_size=img_size, use_native=use_native)


def make_validator(model_cfg: M.SailReconConfig, train_cfg: TrainConfig,
                   ecfg: EvalConfig, img_size: int, device="cuda"):
    """Loads the eval scenes once (to ``device``) and returns
    ``validate(params) -> {"px_residual", "log_residual"}``; the two means
    come to the host in one transfer."""
    from ..data.imc2021 import stack_scenes

    dev = M._device(device)
    ds = load_scenes(ecfg.data_root, ecfg.sample_num, ecfg.num_images, img_size)
    rng = np.random.default_rng(0)  # fixed: the same frames and samples every call
    batch = batch_to_device(stack_scenes([ds.load_scene(i, rng) for i in range(len(ds))]),
                            dev)
    fwd = make_eval_forward(model_cfg, train_cfg, dev)

    @torch.no_grad()
    def validate(params) -> dict:
        preds = fwd(params, batch["images"], **eval_subsample(dev))
        px, lg = [], []
        for b in range(batch["images"].shape[0]):
            scene = {k: v[b] for k, v in batch.items() if k != "images"}
            r = scene_residuals(preds["extrinsic"][b], preds["intrinsic"][b], scene,
                                train_cfg.loss)
            w = r["weights"]
            if ecfg.heldout_from > 0:
                touch = ((r["src_idx"] >= ecfg.heldout_from)
                         | (r["dst_idx"] >= ecfg.heldout_from))
                w = w * touch[:, None].to(w.dtype)
            px.append(_masked_mean(r["residuals"], w))
            lg.append(_masked_mean(r["res_log"], w))
        out = torch.stack([torch.stack(px).mean(), torch.stack(lg).mean()]).tolist()
        return {"px_residual": out[0], "log_residual": out[1]}

    return validate
