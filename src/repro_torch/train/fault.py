"""Fault tolerance and straggler handling for long-running jobs.

``run_resilient`` is the outer driver: it owns checkpoint cadence, watches
per-step wall time for stragglers, and on any failure restores the latest
committed checkpoint and resumes (the data pipeline is a pure function of
step, so replayed steps are bit-identical). A failed collective lands
here as an exception like any other.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from . import checkpoint as ckpt

log = logging.getLogger("repro_torch.fault")


@dataclass
class StragglerMonitor:
    """Flags steps slower than ``threshold`` x trailing median; the driver
    responds per policy ('warn' | 'checkpoint')."""
    window: int = 32
    threshold: float = 3.0
    times: list = field(default_factory=list)

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        self.times = self.times[-self.window:]
        if len(self.times) < 8:
            return False
        hist = sorted(self.times[:-1])
        median = hist[len(hist) // 2]
        return dt > self.threshold * median


@dataclass
class RunReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_events: int = 0
    final_step: int = 0
    metrics: Any = None


def run_resilient(
    *,
    ckpt_dir: str,
    init_state: Callable[[], Any],          # () -> (step, state-tree)
    step_fn: Callable[[int, Any], tuple],   # (step, state) -> (state, metrics)
    total_steps: int,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    straggler: StragglerMonitor | None = None,
    straggler_policy: str = "warn",
    fault_hook: Callable[[int], None] | None = None,   # test injection point
    process_index: int = 0,
    process_count: int = 1,
    barrier: Callable[[], None] | None = None,
) -> RunReport:
    """Run ``step_fn`` from the latest committed checkpoint (or
    ``init_state()``) to ``total_steps``, checkpointing every
    ``ckpt_every`` steps and at the end; on an exception, restart from the
    latest checkpoint, at most ``max_restarts`` times.

    A job of ``process_count`` processes (a mesh's ranks, each holding its
    own shards) saves and restores this process's shard
    (``process_index``); ``barrier`` (every process's, e.g.
    ``torch.distributed.barrier``) runs after each save, so a step is
    committed by all before any reads it. A straggler's checkpoint, which
    one process decides alone, is taken only in a job of one process."""
    io = dict(process_index=process_index, process_count=process_count)

    def save(step, state):
        ckpt.save(ckpt_dir, step, state, **io)
        if barrier is not None:
            barrier()

    report = RunReport()
    straggler = straggler or StragglerMonitor()
    restarts = 0
    while True:
        # ---- (re)start: restore latest committed state if present --------
        step0, state = init_state()
        if ckpt.latest_step(ckpt_dir, process_count) is not None:
            step0, state = ckpt.restore(ckpt_dir, state, **io)
            log.info("restored checkpoint at step %d", step0)
        step = step0
        try:
            while step < total_steps:
                if fault_hook is not None:
                    fault_hook(step)
                t0 = time.monotonic()
                state, metrics = step_fn(step, state)
                dt = time.monotonic() - t0
                step += 1
                report.steps_run += 1
                report.metrics = metrics
                if straggler.observe(dt):
                    report.straggler_events += 1
                    log.warning("straggler step %d: %.3fs", step, dt)
                    if straggler_policy == "checkpoint" and process_count == 1:
                        save(step, state)
                if step % ckpt_every == 0 or step == total_steps:
                    save(step, state)
            report.final_step = step
            report.restarts = restarts
            return report
        except Exception as e:  # noqa: BLE001 -- any failure = node failure
            restarts += 1
            log.error("failure at step %d: %s (restart %d/%d)", step, e,
                      restarts, max_restarts)
            if restarts > max_restarts:
                raise
