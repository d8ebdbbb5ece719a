"""Fault-tolerant training loop.

Counterpart of ``repro.training.loop``.  Responsibilities:
  * periodic ASYNC atomic checkpoints (CheckpointManager);
  * automatic resume from the latest complete checkpoint: the restore puts
    each leaf on the device and in the dtype of the current state's, or,
    given ``state_shardings`` (``training.steps.state_shardings``), onto
    the current mesh as DTensors (elastic: the restore reshards onto
    whatever mesh the restarted job has);
  * per-step retry: a step that raises is retried after restoring the last
    checkpoint (bounded retries -> crash loudly); a NaN loss is a failed
    step;
  * straggler telemetry: per-step wall time EMA; steps slower than
    ``straggler_factor``x the EMA are logged with their step id and passed
    to the ``on_straggler`` hook;
  * metrics to JSONL (step, loss, grad_norm, lr, wall time).

The loop is model-agnostic: it consumes (state, batch) -> (state, metrics)
plus a batch source fn(step) -- the data pipeline is step-keyed, so resume
needs no data state.  Host reads are ``.item()`` after the step; the
loss's waits for the step's device work, so a step's time includes it.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager

__all__ = ["TrainLoopConfig", "TrainLoop"]


@dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep_checkpoints: int = 3
    max_retries: int = 3
    straggler_factor: float = 3.0
    ema_decay: float = 0.9
    log_path: Optional[str] = None
    async_ckpt: bool = True


class TrainLoop:
    def __init__(self, cfg: TrainLoopConfig, step_fn: Callable,
                 batch_fn: Callable, init_state,
                 state_shardings=None,
                 on_straggler: Optional[Callable] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.state = init_state
        self.state_shardings = state_shardings
        self.on_straggler = on_straggler or (lambda step, dt, ema: None)
        self.mgr = CheckpointManager(cfg.ckpt_dir, cfg.keep_checkpoints)
        self.metrics_log: list[dict] = []
        self._ema = None

    # -- persistence ------------------------------------------------------
    def _save(self, step: int):
        tree = {"state": self.state}
        if self.cfg.async_ckpt:
            self.mgr.save_async(step, tree)
        else:
            self.mgr.save(step, tree)

    def _restore(self, step: int):
        shardings = ({"state": self.state_shardings}
                     if self.state_shardings is not None else None)
        self.state = self.mgr.restore(step, {"state": self.state},
                                      shardings)["state"]

    def maybe_resume(self) -> int:
        latest = self.mgr.latest()
        if latest is None:
            return 0
        self._restore(latest)
        return latest

    # -- the loop ---------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> dict:
        step = self.maybe_resume() if start_step is None else start_step
        retries = 0
        stragglers = []
        if self.mgr.latest() is None:
            # bootstrap checkpoint: the step fn CONSUMES its input state
            # (in-place updates), so a failure on the very first steps
            # would otherwise leave nothing to restore from
            self.mgr.save(step, {"state": self.state})
        while step < self.cfg.total_steps:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            try:
                self.state, metrics = self.step_fn(self.state, batch)
                loss = metrics.get("loss")
                if loss is not None:
                    loss = float(loss)
                    if loss != loss:  # NaN: treat as a failed step
                        raise FloatingPointError(f"NaN loss at step {step}")
            except Exception:
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                latest = self.mgr.latest()
                if latest is not None:
                    self._restore(latest)
                    step = latest
                continue
            retries = 0
            dt = time.perf_counter() - t0
            if self._ema is not None and dt > self.cfg.straggler_factor * \
                    self._ema:
                stragglers.append((step, dt))
                self.on_straggler(step, dt, self._ema)
            self._ema = dt if self._ema is None else (
                self.cfg.ema_decay * self._ema
                + (1 - self.cfg.ema_decay) * dt)

            rec = {"step": step, "time_s": dt,
                   **{k: v.item() for k, v in metrics.items()
                      if isinstance(v, torch.Tensor) and v.dim() == 0}}
            self.metrics_log.append(rec)
            if self.cfg.log_path:
                with open(self.cfg.log_path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

            step += 1
            if step % self.cfg.ckpt_every == 0 or step == \
                    self.cfg.total_steps:
                self._save(step)
        self.mgr.join()
        return {"final_step": step, "stragglers": stragglers,
                "metrics": self.metrics_log}
