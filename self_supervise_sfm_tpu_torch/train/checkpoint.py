"""Full train-state checkpoints: save, asynchronous write, deterministic resume.

Port of ``self_supervise_sfm_tpu/train/checkpoint.py`` with its API
(``save``, ``restore(step, template)``, ``latest_step``, ``wait``,
``close``, ``max_to_keep``) and its layout, one directory a step:
``<directory>/<step>/state.pt``, a ``torch.save`` of host copies of the
whole state (params, the Adam moments and count, the step). A save copies
the state to the host at once, since the train step updates it in place
afterwards, then writes it on a background thread, first to ``<step>.tmp``,
renamed to ``<step>`` when complete, so a directory named by a step always
holds a whole checkpoint. ``restore`` puts every tensor back on the
template's device in the template's dtype (``mu`` in ``adam_mu_dtype``).

The JAX package writes orbax directories, which only JAX reads; the port
does not read them. Carry a JAX train state across with
``convert.train_state_from_jax`` and save it here.

A state of a mesh (``save`` / ``restore`` with the train step's
``loop.StateLayout``) is saved whole, so that any mesh resumes it, and the
one-device trainer too (orbax's property, which the JAX trainer relies
on). Every rank calls ``save``: FSDP's slices are gathered leaf by leaf
into rank 0's host memory (one whole state there: 14.93 GB at full width
with a bf16 Adam mu; the device holds one gathered leaf at a time), rank 0
writes the file, and every rank waits at a barrier until it is renamed
into place. On ``restore`` every rank maps the file and keeps its slice
of each leaf.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, List, Optional

import torch
import torch.distributed as dist

_FILE = "state.pt"


def _to_host(tree):
    """A copy of ``tree`` with every tensor on the CPU, detached."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    return tree


def _like(saved, template, path="state", copy=False):
    """``saved`` laid out as ``template``: tensors on the template's device
    and in its dtype (copies with ``copy``), Python numbers as they were
    saved."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"{path}: the checkpoint's keys differ from the template's")
        return {k: _like(saved[k], v, f"{path}/{k}", copy) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
            raise ValueError(f"{path}: the checkpoint's length differs from the template's")
        return [_like(s, t, f"{path}[{i}]", copy)
                for i, (s, t) in enumerate(zip(saved, template))]
    if torch.is_tensor(template):
        if not torch.is_tensor(saved) or saved.shape != template.shape:
            raise ValueError(f"{path}: shape {getattr(saved, 'shape', None)} in the "
                             f"checkpoint, {tuple(template.shape)} in the template")
        return saved.to(template.device, template.dtype, copy=copy)
    return saved


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, layout=None) -> bool:
        """Copy ``state`` to the host and start writing it; False (and
        nothing written) when ``step`` is saved already. With a ``layout``
        (a state of a mesh) every rank calls, rank 0 writes the whole state
        and the call returns once the write is in place."""
        self.wait()
        if step in self.all_steps():
            return False
        if layout is not None:
            self._save_mesh(step, state, layout)
            return True
        host = _to_host(state)
        self._thread = threading.Thread(target=self._write_guarded, args=(step, host),
                                        daemon=True)
        self._thread.start()
        return True

    def _save_mesh(self, step: int, state, layout) -> None:
        primary = dist.get_rank() == 0
        if layout.fsdp or layout.tp:
            host = {k: v for k, v in state.items() if k not in ("params", "opt")}
            host["params"] = layout.gather(state["params"], 0, "cpu")
            host["opt"] = {k: (layout.gather(v, 0, "cpu") if k in ("mu", "nu") else v)
                           for k, v in state["opt"].items()}
        else:
            host = _to_host(state) if primary else None
        error = None
        if primary:
            try:
                self._write(step, host)
            except Exception as e:  # the others must leave the barrier too
                error = e
        del host
        dist.barrier(group=layout.mesh.group(("data", "context")))
        if layout.mesh.shape["model"] > 1:
            dist.barrier(group=layout.mesh.group("model"))
        if error is not None:
            raise RuntimeError("checkpoint write failed") from error

    def _write_guarded(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # re-raised by wait() on the caller's thread
            self._error = e

    def _write(self, step: int, host) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, _FILE))
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep else []:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: Optional[int] = None, template: Any = None,
                layout=None) -> Any:
        """The state saved at ``step`` (default: the latest), or None when
        there is none. With a ``template`` (a state of the same layout),
        its tensors land on the template's devices and dtypes; without, on
        the CPU as saved. With a ``layout`` the template is a rank's state
        of a mesh: each rank keeps its slice of every saved leaf."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), _FILE)
        if layout is None:
            saved = torch.load(path, map_location="cpu", weights_only=True)
            return saved if template is None else _like(saved, template)
        # mapped, not read: a rank copies only the pages of its slices
        saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        for key in ("params", "mu", "nu"):
            tree = saved["params"] if key == "params" else saved["opt"][key]
            cut = layout.shard(tree)
            if key == "params":
                saved["params"] = cut
            else:
                saved["opt"][key] = cut
        return _like(saved, template, copy=True)

    def wait(self) -> None:
        """Block until the last save is on disk; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def close(self) -> None:
        self.wait()
