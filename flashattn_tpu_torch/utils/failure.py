"""Failure detection and recovery for training (counterpart of
flashattn_tpu/utils/failure.py).

What goes wrong, and what this module does about it:

- A numeric blowup (a bad batch, a learning-rate spike) drives the loss
  non-finite: ``check_finite`` detects it at the step; recovery restores
  the last checkpoint and skips the batch (replaying it would fail the
  same way).
- A runtime fault (a card out of memory, a lost peer: ``RUNTIME_FAULTS``)
  takes the same restore-and-continue path, with bounded retries, so that
  a fault that stays fails fast.
- A hang: a collective that never returns blocks the process, and no code
  in it runs after it; recovering from that needs a supervisor that
  restarts the job (``resilient_train`` resumes from the newest
  checkpoint). What one process can see: steps that stay slow
  (``StepTimer``) and a peer that is gone before a long run starts
  (``probe_collectives``: a tiny all-reduce with a deadline, on a side
  thread that stays parked on a hung collective while the caller fails
  fast).

``resilient_train`` is the loop: a checkpoint every N steps, detect,
restore, skip, and a record of every recovery.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from pathlib import Path
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# Faults of the card and the process group that the loop recovers from.
RUNTIME_FAULTS = tuple(getattr(torch, name) for name in ("OutOfMemoryError", "AcceleratorError")
                       if hasattr(torch, name)) + (dist.DistError,)


class TrainingFailure(RuntimeError):
    """A detected training fault. kind: 'nonfinite' | 'timeout' | 'runtime'."""

    def __init__(self, kind: str, message: str):
        super().__init__(f"[{kind}] {message}")
        self.kind = kind


def check_finite(metrics: dict, step: int) -> None:
    """Raise TrainingFailure('nonfinite') if any scalar metric is non-finite.

    Reads each metric back to the host: on the card that waits for the
    step's work. Call it at the logging cadence if that wait shows in a
    profile."""
    for name, val in metrics.items():
        v = float(val)
        if not math.isfinite(v):
            raise TrainingFailure("nonfinite", f"{name}={v} at step {step}")


class StepTimer:
    """Detects steps that stay slow (a hang cannot be detected in the
    process past a blocked collective: module docstring).

    Flags a failure when `patience` consecutive steps each take more than
    `factor` x the baseline (the median of the first `calibrate` steps);
    one slow step (a checkpoint write) does not trip it.

    The clock is the host's: on the card a step's host time is the time to
    launch its work unless the step ends in a sync. Time a step that ends
    in one: pass ``stop`` a tensor the step produced (its loss), which is
    read back to the host before the clock is read."""

    def __init__(self, factor: float = 10.0, calibrate: int = 5, patience: int = 3):
        self.factor = factor
        self.calibrate = calibrate
        self.patience = patience
        self._samples: list[float] = []
        self._slow = 0
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, step: int, result: torch.Tensor | None = None) -> float:
        """The step's seconds since start(); `result` (the step's loss) is
        read back first, so the time covers the device's work."""
        if self._t0 is None:
            raise RuntimeError("stop() without start()")
        if result is not None:
            float(result)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        if len(self._samples) < self.calibrate:
            self._samples.append(dt)
            return dt
        baseline = float(np.median(self._samples))
        if dt > self.factor * baseline:
            self._slow += 1
            if self._slow >= self.patience:
                raise TrainingFailure(
                    "timeout",
                    f"{self._slow} consecutive steps > {self.factor:.0f}x "
                    f"baseline ({dt:.3f}s vs {baseline:.3f}s) at step {step}")
        else:
            self._slow = 0
        return dt


def probe_collectives(mesh, timeout_s: float = 60.0, device: torch.device | str = "cuda"
                      ) -> bool:
    """Fail-fast health probe of every rank of `mesh` (every rank calls it):
    one all-reduce of each rank's index on `device` (the card unless the
    caller names the CPU) with a deadline, checked against the sum it must
    give. Run it before a long run (start-up, resume): a dead or cut-off
    peer hangs the collective, and the side thread, not the training loop,
    parks on it. Returns False on a timeout, a wrong sum or an error."""
    from flashattn_tpu_torch.parallel.distributed import all_reduce

    result: dict = {}
    n = math.prod(mesh.shape.values())  # the mesh lays out every rank of the default group
    rank = dist.get_rank() if dist.is_initialized() else 0

    def _probe():
        try:
            x = torch.full((1,), float(rank), dtype=torch.float32, device=device)
            total = all_reduce(x) if n > 1 else x
            result["ok"] = float(total) == n * (n - 1) / 2
        except Exception as e:  # noqa: BLE001: any fault means unhealthy
            logger.warning("collective probe failed: %s", e)
            result["ok"] = False

    t = threading.Thread(target=_probe, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        logger.error("collective probe hung > %.1fs (dead peer?)", timeout_s)
        return False
    return result.get("ok", False)


@dataclasses.dataclass
class RecoveryEvent:
    step: int
    kind: str
    message: str
    restored_step: int


def resilient_train(
    state: dict,
    data: Iterator,
    step_fn: Callable[[dict, object], tuple[dict, dict]],
    steps: int,
    ckpt_dir: str | Path,
    ckpt_every: int = 100,
    max_recoveries: int = 3,
    step_timer: StepTimer | None = None,
    check_every: int = 1,
) -> tuple[dict, list[RecoveryEvent]]:
    """Checkpointed training loop with detect-restore-skip recovery.

    `state` is models/train.py's (init_train_state); step_fn(state, batch)
    -> (state, metrics), such as train.train_step. On a TrainingFailure
    (non-finite metrics, steps that stay slow) or a RUNTIME_FAULTS error,
    the loop restores the newest checkpoint into the state
    (train.restore_checkpoint) and goes on with the NEXT batch: the failing
    batch is consumed and skipped, and the event recorded. After
    `max_recoveries` restores the failure is raised again.

    A process that dies is covered by the same checkpoints: a new process
    restores the newest one (train.restore_checkpoint) and runs on.
    """
    from flashattn_tpu_torch.models.train import restore_checkpoint, save_checkpoint

    ckpt_dir = Path(ckpt_dir)
    events: list[RecoveryEvent] = []
    save_checkpoint(ckpt_dir, state)  # so that a failure at the first step can restore
    target = int(state["step"]) + steps
    while int(state["step"]) < target:
        batch = next(data)
        before = int(state["step"])
        try:
            if step_timer is not None:
                step_timer.start()
            state, metrics = step_fn(state, batch)
            step = int(state["step"])
            if step % check_every == 0:
                check_finite(metrics, step)
            if step_timer is not None:
                step_timer.stop(step, metrics.get("loss"))
        except (TrainingFailure, *RUNTIME_FAULTS) as e:
            kind = e.kind if isinstance(e, TrainingFailure) else "runtime"
            if len(events) >= max_recoveries:
                raise
            state = restore_checkpoint(ckpt_dir, state)
            events.append(RecoveryEvent(step=before, kind=kind, message=str(e),
                                        restored_step=int(state["step"])))
            logger.warning("recovered from %s at step %s -> restored step %s "
                           "(skipping the failing batch)", kind, before, int(state["step"]))
            continue
        if step % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state)
    save_checkpoint(ckpt_dir, state)
    return state, events
