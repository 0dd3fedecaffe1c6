"""Fault tolerance: restartable training, preemption, stragglers.

Counterpart of ``repro.distributed.fault_tolerance``, with its semantics:

  * ``RestartableLoop``: a checkpoint cadence and resume from the newest
    checkpoint; a raised ``SimulatedFailure`` (or a real crash) and a
    relaunch with the same arguments continue bit for bit.
  * ``PreemptionSignal``: a SIGTERM-style flag the loop polls every step,
    to checkpoint and return inside the grace window.
  * ``StragglerMonitor``: a robust (median/MAD) z-score of each step's wall
    time against the window before it.

As in the reference, ``run`` iterates ``batches`` from its start: the
training CLI builds a fresh batch stream at every launch, so a resumed run
feeds batches 0, 1, ... again from the restored step (``ROADMAP.md`` Queue
3, "Reference caveats").

One difference of timing, not of semantics: a step's time runs to the end
of ``on_metrics``, where a caller reads the loss. On the card ``step_fn``
returns before the device has run the step, so the call alone would time
the host's launches only.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from .checkpointing import CheckpointManager

__all__ = ["SimulatedFailure", "PreemptionSignal", "StragglerMonitor", "RestartableLoop"]


class SimulatedFailure(RuntimeError):
    """Injected node failure for tests."""


class PreemptionSignal:
    """A flag set by ``set()`` or, with ``install_sigterm``, by SIGTERM
    (the handler is installed from the main thread; ``uninstall`` puts the
    previous one back)."""

    def __init__(self, install_sigterm: bool = False):
        self._flag = False
        self._previous = None
        if install_sigterm:
            self._previous = signal.signal(signal.SIGTERM, lambda *_: self.set())

    def set(self) -> None:
        self._flag = True

    def triggered(self) -> bool:
        return self._flag

    def uninstall(self) -> None:
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None


@dataclass
class StragglerMonitor:
    window: int = 50
    threshold: float = 4.0  # robust z-score (MAD-based)
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> bool:
        """Add one step's time; True (and the step in ``flagged``) when it
        lies ``threshold`` robust deviations above the window's median."""
        self.times.append(seconds)
        hist = np.asarray(self.times[-self.window:])
        if hist.size < 8:
            return False
        med = np.median(hist[:-1])
        mad = np.median(np.abs(hist[:-1] - med)) + 1e-9
        z = (seconds - med) / (1.4826 * mad)
        if z > self.threshold:
            self.flagged.append((step, seconds, float(z)))
            return True
        return False


class RestartableLoop:
    """Drives ``step_fn(state, batch) -> (state, metrics)`` with checkpoint
    and restart semantics. Construction restores the newest checkpoint under
    ``ckpt`` (with ``resume="auto"``) into the structure of
    ``init_state_fn()``, so a crashed process relaunched with the same
    arguments continues where it stopped. ``ckpt=None``: no checkpoints
    and no resume."""

    def __init__(self, ckpt: CheckpointManager | None, init_state_fn: Callable[[], Any],
                 save_every: int = 50, preemption: PreemptionSignal | None = None,
                 straggler: StragglerMonitor | None = None, resume: str = "auto"):
        if resume not in ("auto", "never"):
            raise ValueError(f"resume must be 'auto' or 'never', got {resume!r}")
        self.ckpt = ckpt
        self.save_every = save_every
        self.preemption = preemption or PreemptionSignal()
        self.straggler = straggler or StragglerMonitor()
        latest = ckpt.latest_step() if ckpt is not None and resume == "auto" else None
        if latest is not None:
            self.state, self.start_step = ckpt.restore(init_state_fn(), latest)
            self.resumed = True
        else:
            self.state = init_state_fn()
            self.start_step = 0
            self.resumed = False

    def _save(self, step: int) -> None:
        if self.ckpt is not None:
            self.ckpt.save(self.state, step)

    def run(self, step_fn, batches, n_steps: int, fail_at: int | None = None,
            on_metrics: Callable | None = None):
        """Returns (state, last step completed). ``fail_at`` raises
        ``SimulatedFailure`` after that step completes (after its
        checkpoint, if the cadence takes one)."""
        step = self.start_step
        it = iter(batches)
        while step < n_steps:
            batch = next(it)
            t0 = time.perf_counter()
            self.state, metrics = step_fn(self.state, batch)
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            self.straggler.record(step, time.perf_counter() - t0)
            if step % self.save_every == 0 or step == n_steps:
                self._save(step)
            if self.preemption.triggered():
                self._save(step)
                self.wait()
                return self.state, step
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
        self.wait()
        return self.state, step

    def wait(self) -> None:
        if self.ckpt is not None:
            self.ckpt.wait()
