"""Structured metrics: a JSON-lines curve, TensorBoard scalars, the console.

Port of ``self_supervise_sfm_tpu/train/metrics.py``: ``metrics.jsonl``
always, TensorBoard event files when ``tensorboardX`` imports, and a
console line every ``console_every`` steps, each with the seconds since the
previous write."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str] = None, console_every: int = 10):
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:
                pass
        self.console_every = console_every
        self._last_time = time.perf_counter()

    def write(self, step: int, scalars: Dict[str, float], prefix: str = "train"):
        now = time.perf_counter()
        scalars = dict(scalars)
        scalars.setdefault("step_seconds", now - self._last_time)
        self._last_time = now
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{prefix}/{k}", float(v), step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(
                {"step": step, "prefix": prefix,
                 **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._jsonl.flush()
        if self.console_every and step % self.console_every == 0:
            msg = " ".join(f"{k}={float(v):.5g}" for k, v in scalars.items())
            print(f"[{prefix} {step}] {msg}", flush=True)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
