"""Elastic scaling + straggler mitigation hooks.

The port of ``repro.distributed.elastic``.

Elasticity: checkpoints are saved unsharded (gathered), so scaling in/out
is "restore onto the new mesh" — :func:`reshard_tree` places a host tree
onto any mesh via the same logical rules.  The data pipeline is a pure
function of the step counter, so a re-sharded restart replays the
identical global batch stream.

Straggler mitigation: a real multi-host deployment cannot observe its
peers' progress from inside a step, so :class:`StepWatchdog` wraps the
host-side loop: it tracks a robust (median + MAD) step-time envelope and
fires a callback when the current step exceeds the deadline, which a
launcher maps to "checkpoint-and-evict".  Unlike the reference's,
``guard`` re-raises an exception of the step in the caller's thread (the
reference's waits for ever on a step that raised).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .sharding import AxisRules, param_sharding

__all__ = ["reshard_tree", "StepWatchdog", "place"]


def place(value, sharding):
    """A ``DTensor`` of ``value`` (numpy array or tensor) laid on
    ``sharding.mesh`` as ``sharding`` says.  Every rank holds the whole
    value, so each keeps its own block and nothing is sent
    (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value))
    return distribute_tensor(value.to(sharding.mesh.device_type), sharding.mesh,
                             sharding.placements, src_data_rank=None)


def reshard_tree(host_tree, spec_tree, mesh, rules: AxisRules | None = None):
    """Place a host (numpy or tensor) tree onto ``mesh`` under logical
    specs: a tree of ``DTensor``s, each rank holding its blocks."""
    sh = param_sharding(mesh, spec_tree, rules)

    def walk(h, s):
        if isinstance(h, dict):
            return {k: walk(v, s[k]) for k, v in h.items()}
        return place(h, s)

    return walk(host_tree, sh)


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
