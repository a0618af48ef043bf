"""Lock construction for ``repro_torch.core`` (race-detector seam).

All ``threading.Lock``/``RLock`` instances in the core are minted here so
the dynamic race detector (``repro_torch.tools.racecheck``) can substitute
instrumented equivalents.  With ``DSLOG_RACE_DETECT`` unset (the default)
these helpers return plain ``threading`` primitives and wrap nothing — zero
steady-state overhead, one env lookup at construction.

Every lock carries a name from the declared order table in
``repro_torch.tools.lockorder``, rank for rank the reference's
(``repro.tools.lockorder``): the static lint looks a lock up by (module
stem, attribute), and the port keeps the reference's module stems and
attribute names, so each port lock resolves to the same declared rank.
"""

from __future__ import annotations

import os
import threading


def _detect() -> bool:
    return os.environ.get("DSLOG_RACE_DETECT", "") not in ("", "0")


def new_lock(name: str):
    """A non-reentrant mutex named per the lock-order table."""
    if _detect():
        from repro_torch.tools.racecheck import InstrumentedLock

        return InstrumentedLock(name, reentrant=False)
    return threading.Lock()


def new_rlock(name: str):
    """A reentrant mutex named per the lock-order table."""
    if _detect():
        from repro_torch.tools.racecheck import InstrumentedLock

        return InstrumentedLock(name, reentrant=True)
    return threading.RLock()


def guard_mapping(data, guard, label: str):
    """Register a dict as shared state guarded by ``guard``.

    Under the race detector this returns a ``GuardedDict`` that flags
    mutations performed without ``guard`` held; otherwise it returns a plain
    dict built from ``data``.
    """
    if _detect():
        from repro_torch.tools.racecheck import GuardedDict, InstrumentedLock

        if isinstance(guard, InstrumentedLock):
            return GuardedDict(data, guard, label)
    return dict(data)


def guard_sequence(data, guard, label: str):
    """List counterpart of :func:`guard_mapping` (shard caches)."""
    if _detect():
        from repro_torch.tools.racecheck import GuardedList, InstrumentedLock

        if isinstance(guard, InstrumentedLock):
            return GuardedList(data, guard, label)
    return list(data)
