"""Lock construction for ``repro_torch.core`` (race-detector seam).

All ``threading.Lock``/``RLock`` instances in the core are minted here, as
in ``repro.core._locks``, so a dynamic race detector can substitute
instrumented equivalents once the port's tools exist (ROADMAP.md §1 "Still
to port" item 4).  Until then these helpers return plain ``threading``
primitives and wrap nothing; ``DSLOG_RACE_DETECT`` is not read.

Every lock carries a name from the reference's declared order table
(``repro.tools.lockorder``): the static lint looks a lock up by (module
stem, attribute), and the port keeps the reference's module stems and
attribute names, so each port lock resolves to the same declared rank.
"""

from __future__ import annotations

import threading


def new_lock(name: str):
    """A non-reentrant mutex named per the lock-order table."""
    return threading.Lock()


def new_rlock(name: str):
    """A reentrant mutex named per the lock-order table."""
    return threading.RLock()


def guard_mapping(data, guard, label: str):
    """Register a dict as shared state guarded by ``guard``.

    Returns a plain dict built from ``data``; the guarded wrapper comes
    with the race detector.
    """
    return dict(data)


def guard_sequence(data, guard, label: str):
    """List counterpart of :func:`guard_mapping`."""
    return list(data)
