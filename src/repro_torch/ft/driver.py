"""Fault-tolerant training driver.

Responsibilities at fleet scale (and their single-host test analogues):

* checkpoint/restart  — periodic async checkpoints; on start, resume
  from the newest committed step (crash-in-the-middle leaves only a
  .tmp dir, which restore ignores).
* preemption handling — SIGTERM triggers a synchronous final checkpoint
  before exit (the preemption notice path).
* straggler watch     — per-step wall time vs. running median; steps
  slower than ``straggler_factor`` x median are counted and surfaced
  (the fleet-level actor would re-schedule the slow host; here we
  expose the signal + hook).
* heartbeat           — a per-host heartbeat file updated each step; a
  coordinator watching mtimes detects dead hosts and triggers the
  elastic-restore path (restore onto the surviving mesh).

With ``mesh`` / ``specs`` (a torch ``DeviceMesh`` and the state's spec
tree) a resume restores the state onto the mesh, as the reference's
does; without them, onto its template's devices.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Any, Callable, Iterator

import numpy as np

from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.ft.heartbeat import write_heartbeat

__all__ = ["DriverConfig", "TrainDriver"]


@dataclasses.dataclass
class DriverConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_steps: int = 200
    straggler_factor: float = 3.0
    heartbeat_path: str | None = None
    on_straggler: Callable[[int, float], None] | None = None


class TrainDriver:
    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 state: Any, data: Iterator, *,
                 state_template: Any = None, mesh=None, specs: Any = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.data = data
        self.mesh = mesh
        self.specs = specs
        self.state_template = state_template if state_template is not None \
            else state
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.step = 0
        self.step_times: list[float] = []
        self.straggler_steps: list[int] = []
        self.metrics_history: list[dict] = []
        #: seconds the final synchronous checkpoint took
        self.final_ckpt_s: float | None = None
        self._preempted = False

    # -- lifecycle ----------------------------------------------------------
    def maybe_resume(self) -> int:
        last = latest_step(self.cfg.ckpt_dir)
        if last is not None:
            self.state = restore_checkpoint(
                self.cfg.ckpt_dir, last, self.state_template,
                mesh=self.mesh, specs=self.specs)
            self.step = last
        return self.step

    def _handle_preempt(self, signum, frame) -> None:  # pragma: no cover
        self._preempted = True

    def _heartbeat(self) -> None:
        if self.cfg.heartbeat_path:
            write_heartbeat(self.cfg.heartbeat_path, self.step)

    # -- main loop ------------------------------------------------------------
    def run(self) -> dict:
        old = signal.signal(signal.SIGTERM, self._handle_preempt)
        try:
            for batch in self.data:
                if self.step >= self.cfg.max_steps or self._preempted:
                    break
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                dt = time.perf_counter() - t0
                self.step += 1
                self.step_times.append(dt)
                self.metrics_history.append(
                    {k: float(v) for k, v in metrics.items()})
                self._heartbeat()
                # straggler detection on the step-time stream
                if len(self.step_times) >= 5:
                    med = float(np.median(self.step_times[-50:]))
                    if dt > self.cfg.straggler_factor * med:
                        self.straggler_steps.append(self.step)
                        if self.cfg.on_straggler:
                            self.cfg.on_straggler(self.step, dt)
                if self.step % self.cfg.ckpt_every == 0:
                    self.ckpt.save(self.step, self.state)
        finally:
            signal.signal(signal.SIGTERM, old)
        # final (synchronous) checkpoint — preemption or normal exit
        self.ckpt.wait()
        t0 = time.perf_counter()
        save_checkpoint(self.cfg.ckpt_dir, self.step, self.state)
        self.final_ckpt_s = time.perf_counter() - t0
        return {
            "step": self.step,
            "preempted": self._preempted,
            "stragglers": list(self.straggler_steps),
            "last_metrics": (self.metrics_history[-1]
                             if self.metrics_history else {}),
        }
