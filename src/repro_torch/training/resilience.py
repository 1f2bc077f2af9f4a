"""Fault tolerance + straggler mitigation for 1000+ node deployments.

The pieces a real multi-pod run needs, built so the control logic is
fully testable in this container:

  * HeartbeatMonitor — per-worker liveness with configurable timeout;
    on expiry the supervisor declares the worker dead.
  * StragglerDetector — per-step worker durations; a worker slower than
    ``threshold x`` the p50 for ``patience`` consecutive steps is flagged
    (real deployments swap it out / re-shard around it).
  * TrainingSupervisor — checkpoint/restart orchestration: runs the step
    function, saves every ``ckpt_every``, and on an injected/declared
    failure restores the latest checkpoint and continues, optionally on
    a *different* mesh shape (elastic scale-down: lost pod -> continue on
    the survivors).  tests/test_training.py exercises loss-continuity
    across a failure and a reshard.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class WorkerState:
    last_beat: float
    durations: List[float] = dataclasses.field(default_factory=list)
    flagged: int = 0


class HeartbeatMonitor:
    def __init__(self, workers: List[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.workers: Dict[str, WorkerState] = {
            w: WorkerState(last_beat=clock()) for w in workers}

    def beat(self, worker: str) -> None:
        self.workers[worker].last_beat = self.clock()

    def dead_workers(self) -> List[str]:
        now = self.clock()
        return [w for w, s in self.workers.items()
                if now - s.last_beat > self.timeout_s]


class StragglerDetector:
    """Flags workers persistently slower than the fleet median."""

    def __init__(self, threshold: float = 1.5, patience: int = 3):
        self.threshold = threshold
        self.patience = patience
        self._flags: Dict[str, int] = {}

    def observe(self, step_durations: Dict[str, float]) -> List[str]:
        med = float(np.median(list(step_durations.values())))
        out = []
        for w, d in step_durations.items():
            if d > self.threshold * med:
                self._flags[w] = self._flags.get(w, 0) + 1
            else:
                self._flags[w] = 0
            if self._flags[w] >= self.patience:
                out.append(w)
        return out


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str = "worker_loss"        # worker_loss | preemption
    new_mesh: Optional[tuple] = None  # elastic: continue on this mesh


class TrainingSupervisor:
    """Checkpoint/restart driver.  ``step_fn(state, batch) -> (state,
    metrics)``; ``reshard_fn(state, mesh_shape) -> state`` re-places the
    state for an elastic mesh change."""

    def __init__(self, step_fn: Callable, ckpt_manager, *,
                 ckpt_every: int = 10,
                 reshard_fn: Optional[Callable] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.reshard_fn = reshard_fn
        self.restarts = 0
        self.log: List[dict] = []

    def run(self, state: Any, batches, *, start_step: int = 0,
            failures: Optional[List[FailureEvent]] = None) -> Any:
        failures = {f.step: f for f in (failures or [])}
        step = start_step
        for batch in batches:
            if step in failures:
                ev = failures.pop(step)
                self.restarts += 1
                latest = self.ckpt.latest
                if latest is None:
                    raise RuntimeError("failure before first checkpoint")
                state = self.ckpt.restore(state)
                step = latest
                if ev.new_mesh is not None and self.reshard_fn is not None:
                    state = self.reshard_fn(state, ev.new_mesh)
                self.log.append({"event": "restart", "from_step": latest,
                                 "kind": ev.kind, "mesh": ev.new_mesh})
                continue
            state, metrics = self.step_fn(state, batch)
            step += 1
            self.log.append({"event": "step", "step": step,
                             "loss": float(metrics["loss"])})
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.wait()
        return state
