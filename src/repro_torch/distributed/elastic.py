"""Straggler mitigation for the host training loop.

The port of ``repro.distributed.elastic``'s ``StepWatchdog``, which
imports nothing of JAX.  A real multi-host deployment cannot observe its
peers' progress from inside a step, so the watchdog wraps the host-side
loop: it tracks a robust (median + MAD) step-time envelope and fires a
callback when the current step exceeds the deadline, which a launcher maps
to "checkpoint-and-evict".  Unlike the reference's, ``guard`` re-raises
an exception of the step in the caller's thread (the reference's waits
for ever on a step that raised).  ``reshard_tree`` (placing a host tree
onto a mesh) comes with the port's distributed slice, which brings the
meshes and parameter shardings it needs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

__all__ = ["StepWatchdog"]


@dataclass
class StepWatchdog:
    """Deadline-based straggler detector for the host training loop."""

    factor: float = 3.0  # deadline = median + factor * MAD (+ floor)
    floor_s: float = 1.0
    history: list = field(default_factory=list)
    max_history: int = 64
    fired: int = 0

    def observe(self, dt: float) -> None:
        self.history.append(dt)
        if len(self.history) > self.max_history:
            self.history.pop(0)

    def deadline(self) -> float:
        if len(self.history) < 3:
            return float("inf")
        h = sorted(self.history)
        med = h[len(h) // 2]
        mad = sorted(abs(x - med) for x in h)[len(h) // 2]
        return med + self.factor * max(mad, 1e-3) + self.floor_s

    def guard(self, step_fn, *args, on_straggler=None, **kw):
        """Run one step; if it exceeds the deadline, invoke the callback
        (which in production checkpoints + re-meshes without the slow host)."""
        deadline = self.deadline()
        done = threading.Event()
        result: list = []
        error: list = []

        def runner():
            try:
                result.append(step_fn(*args, **kw))
            except BaseException as exc:  # re-raised in the caller's thread
                error.append(exc)
            finally:
                done.set()

        t0 = time.monotonic()
        th = threading.Thread(target=runner, daemon=True)
        th.start()
        fired_here = False
        while not done.wait(timeout=0.05):
            if time.monotonic() - t0 > deadline and not fired_here:
                fired_here = True
                self.fired += 1
                if on_straggler is not None:
                    on_straggler(time.monotonic() - t0, deadline)
        th.join()
        self.observe(time.monotonic() - t0)
        if error:
            raise error[0]
        return result[0]
