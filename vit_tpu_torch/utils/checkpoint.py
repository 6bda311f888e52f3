"""Checkpoints of a training run (port of ``vit_tpu/utils/checkpoint.py`` on
``torch.save`` / ``torch.load(weights_only=True)``).

A checkpoint is one file holding the whole ``TrainState``: the model's
``state_dict``, the optimizer's (its moments) and the learning-rate
schedule's, the step, and the generator states (the state's own generator,
PyTorch's default CPU one and, where there is a card, the CUDA ones), plus
an ``Ema``'s shadow where one is given. Restoring into a state built the
same way (``create_train_state`` with the same model and optimizer recipe)
makes the next step the one the saved run would have taken.

``vit_tpu`` writes through orbax and can re-shard onto another mesh
(``abstract_train_state``); the port has one card and loads onto the
parameters' own device. As ``vit_tpu``'s, ``CheckpointManager`` saves
asynchronously by default: ``save`` copies the state to host memory and
returns, and a writer thread writes the file while training goes on.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import re
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from vit_tpu_torch.augment import Ema

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")
_MANIFEST = "metrics.json"


def _state_dict(state, ema=None) -> dict:
    ckpt = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": int(state.step),
        "generator": None if state.generator is None else state.generator.get_state(),
        "cpu_rng": torch.get_rng_state(),
        "cuda_rng": torch.cuda.get_rng_state_all() if torch.cuda.is_available() else [],
    }
    if ema is not None:
        ckpt["ema"] = ema.state_dict()
    return ckpt


def _write(path, ckpt: dict) -> None:
    path = Path(path).absolute()
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(ckpt, tmp)
    os.replace(tmp, path)


def save_checkpoint(path, state, *, ema=None) -> None:
    """Write ``state`` (a ``TrainState``) and ``ema`` to the file ``path``,
    through a temporary file renamed into place, so a reader never sees a
    half-written checkpoint."""
    _write(path, _state_dict(state, ema))


def _to_host(obj):
    """A copy of a checkpoint's nest of dicts, lists and tuples that no
    training step can change: each card tensor copied into pinned host
    memory with ``non_blocking=True`` on the current stream (so after the
    work already queued there, and before any step queued later), each host
    tensor cloned."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            host = torch.empty(obj.shape, dtype=obj.dtype, pin_memory=True)
            return host.copy_(obj.detach(), non_blocking=True)
        return obj.detach().clone()
    if isinstance(obj, dict):
        return type(obj)((k, _to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def restore_checkpoint(path, state, *, ema=None):
    """Load the file ``path`` into ``state`` (and ``ema``) in place, the
    tensors onto the parameters' device; returns ``state``. An ``ema`` the
    checkpoint does not hold starts from the restored parameters."""
    ema_device = next(state.model.parameters()).device
    ckpt = torch.load(Path(path).absolute(), map_location="cpu", weights_only=True)
    state.model.load_state_dict(ckpt["model"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    if (ckpt["generator"] is None) != (state.generator is None):
        raise ValueError("the checkpoint and the state disagree on having a generator")
    if state.generator is not None:
        state.generator.set_state(ckpt["generator"])
    torch.set_rng_state(ckpt["cpu_rng"])
    if ckpt["cuda_rng"] and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(ckpt["cuda_rng"])
    if ema is not None:
        if "ema" in ckpt:
            ema.load_state_dict(ckpt["ema"])
            ema.params = {k: v.to(ema_device) for k, v in ema.params.items()}
        else:  # a run that kept no EMA: the shadow starts from the restored weights
            ema.params = Ema.init(state.model, ema.decay).params
    return state


class CheckpointManager:
    """Step-numbered checkpoints in ``directory`` (``step_<N>.pt``), with
    retention and cadence::

        with CheckpointManager(run_dir, max_to_keep=3) as mgr:
            for _ in range(total):
                loss = step(state, images, labels)
                if mgr.should_save(state.step):
                    mgr.save(state.step, state, metrics={"loss": float(loss)})
        CheckpointManager(run_dir).restore(state)   # the latest step

    ``max_to_keep`` (None: all) keeps the newest steps, or, with ``best_fn``
    (metrics -> a number), the best by ``best_mode`` ("max" or "min"; a step
    saved without metrics ranks last). The metrics live in
    ``directory/metrics.json``.

    With ``async_save`` (the default, as ``vit_tpu``'s) ``save`` copies the
    state to host memory (pinned, ``non_blocking``, one event for the whole
    copy) and returns; a writer thread waits for that event, writes the file
    and only then updates the manifest and drops the steps beyond
    ``max_to_keep``. The caller may change the parameters as soon as
    ``save`` returns. One save is pending at a time: a second ``save`` waits
    for the first. ``wait`` blocks until the pending save is on disk and
    raises the writer's error, if any; ``close`` (and leaving a ``with``
    block) waits, then stops the thread. ``async_save=False`` writes before
    ``save`` returns."""

    def __init__(self, directory, *, max_to_keep: Optional[int] = 3,
                 save_interval_steps: int = 1, best_fn: Optional[Callable[[dict], float]] = None,
                 best_mode: str = "max", async_save: bool = True):
        if best_mode not in ("max", "min"):
            raise ValueError(f"best_mode must be 'max' or 'min', got {best_mode!r}")
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep, self.interval = max_to_keep, save_interval_steps
        self.best_fn, self.best_mode = best_fn, best_mode
        self.async_save = async_save
        self._writer: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None
        self._pending_step: Optional[int] = None
        self._lock = threading.Lock()

    def path(self, step: int) -> Path:
        return self.directory / f"step_{int(step)}.pt"

    def _disk_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(self.directory))
                      if m)

    def all_steps(self) -> List[int]:
        """The saved steps, once the pending save is on disk."""
        self.wait()
        return self._disk_steps()

    def latest_step(self) -> Optional[int]:
        """The newest step on disk or pending (without waiting for it)."""
        steps = self._disk_steps()
        if self._pending_step is not None:
            steps.append(self._pending_step)
        return max(steps) if steps else None

    def _metrics(self) -> Dict[int, Optional[dict]]:
        f = self.directory / _MANIFEST
        return {int(k): v for k, v in json.loads(f.read_text()).items()} if f.exists() else {}

    def _rank(self, metrics: Dict[int, Optional[dict]]) -> List[int]:
        """The saved steps, best first: by ``best_fn`` where given (steps
        without metrics last, newest first among equals), else newest first."""
        steps = self._disk_steps()[::-1]
        if self.best_fn is None:
            return steps
        sign = -1.0 if self.best_mode == "max" else 1.0
        key = lambda s: (metrics.get(s) is None,
                         0.0 if metrics.get(s) is None else sign * self.best_fn(metrics[s]))
        return sorted(steps, key=key)

    def best_step(self) -> Optional[int]:
        """The best saved step by ``best_fn`` (None without one, or without
        a step saved with metrics)."""
        if self.best_fn is None:
            return None
        self.wait()
        metrics = self._metrics()
        ranked = [s for s in self._rank(metrics) if metrics.get(s) is not None]
        return ranked[0] if ranked else None

    def should_save(self, step: int) -> bool:
        """Whether ``save(step)`` would write: the cadence hits, the step is
        not saved, and no later step is."""
        latest = self.latest_step()
        return int(step) % self.interval == 0 and (latest is None or int(step) > latest)

    def save(self, step: int, state, *, metrics: Optional[dict] = None, ema=None,
             force: bool = False) -> bool:
        """Checkpoint ``state`` at ``step``; False where the cadence skips it
        (``force`` overrides the cadence) or the step is saved already (a step
        is written once). Once the file is written, drop the steps beyond
        ``max_to_keep``. With ``async_save`` the write happens on the writer
        thread after ``save`` has returned (the class docstring)."""
        step = int(step)
        self.wait()  # one pending save at a time; raises a failed one's error
        if step in self._disk_steps() or not (force or self.should_save(step)):
            return False
        ckpt = _state_dict(state, ema)
        if not self.async_save:
            self._commit(step, ckpt, metrics, None)
            return True
        ckpt = _to_host(ckpt)
        copied = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            copied = torch.cuda.Event()
            copied.record()
        with self._lock:
            if self._writer is None:
                self._writer = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint-writer")
            self._pending_step = step
            self._pending = self._writer.submit(self._commit, step, ckpt, metrics, copied)
        return True

    def _commit(self, step: int, ckpt: dict, metrics: Optional[dict], copied) -> None:
        """Write ``ckpt`` as ``step`` (after the copy event ``copied``, where
        given), then update the manifest and apply ``max_to_keep``."""
        if copied is not None:
            copied.synchronize()
        _write(self.path(step), ckpt)
        table = self._metrics()
        table[step] = metrics
        if self.max_to_keep is not None:
            for old in self._rank(table)[self.max_to_keep:]:
                self.path(old).unlink()
                table.pop(old, None)
        (self.directory / _MANIFEST).write_text(json.dumps({str(k): v for k, v in table.items()}))

    def restore(self, state, step: Optional[int] = None, *, ema=None):
        """Load ``step`` (default: the latest) into ``state`` in place, once
        the pending save is on disk."""
        self.wait()
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_checkpoint(self.path(step), state, ema=ema)

    def wait(self) -> None:
        """Block until the pending save (if any) is on disk, its manifest and
        retention applied; raise its writer's error here if it failed."""
        with self._lock:
            pending, self._pending = self._pending, None
        if pending is None:
            return
        try:
            pending.result()
        finally:
            self._pending_step = None

    def close(self) -> None:
        """``wait``, then stop the writer thread (a later ``save`` starts a
        new one)."""
        try:
            self.wait()
        finally:
            with self._lock:
                writer, self._writer = self._writer, None
            if writer is not None:
                writer.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
