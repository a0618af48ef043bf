"""Dynamic lock-order / race detector (layer 2 of the analysis subsystem).

Opt-in: when ``DSLOG_RACE_DETECT=1``, ``repro_torch.core._locks`` constructs
:class:`InstrumentedLock` objects instead of plain ``threading`` primitives
and wraps registered shared state (``io_stats``, ``hop_stats``, shard
caches, WAL counters) in :class:`GuardedDict` / :class:`GuardedList`.  The
instrumentation records, per thread:

* the stack of locks currently held, checking each new acquisition against
  the declared rank table in :mod:`repro_torch.tools.lockorder` (acquiring a lock
  ranked at or below one already held is an ordering violation);
* the aggregated held→acquired edge graph across *all* threads, in which a
  cycle means two threads can deadlock even if neither ever violated the
  rank table (the table may be incomplete for unranked locks);
* every mutation of guarded shared state performed while the guarding lock
  is not held by the mutating thread.

Findings are accumulated in a process-global registry — they do **not**
raise at the point of detection (that would perturb the interleaving under
test) — and are asserted empty by the ``race_detector`` pytest fixture's
teardown.  Everything is a no-op unless the env var is set, so production
code paths pay only one ``os.environ`` lookup at *lock construction* time
and zero per-operation cost.
"""

from __future__ import annotations

import os
import threading
import traceback
from typing import Iterator

from .lockorder import rank

_ENV_VAR = "DSLOG_RACE_DETECT"


def detect_enabled() -> bool:
    return os.environ.get(_ENV_VAR, "") not in ("", "0")


# --------------------------------------------------------------------------
# global registry
# --------------------------------------------------------------------------

_registry_lock = threading.Lock()
_violations: list[str] = []
# (held_name, acquired_name) → short provenance string for the first sighting
_edges: dict[tuple[str, str], str] = {}
_tls = threading.local()


def _held_stack() -> list["InstrumentedLock"]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _caller(depth: int = 3) -> str:
    frame = traceback.extract_stack(limit=depth + 1)[0]
    return f"{os.path.basename(frame.filename)}:{frame.lineno}"


def _record_violation(msg: str) -> None:
    with _registry_lock:
        _violations.append(msg)


def reset() -> None:
    """Drop all accumulated findings and edges (per-test isolation)."""
    with _registry_lock:
        _violations.clear()
        _edges.clear()


def _graph_cycles() -> list[str]:
    """Cycles in the aggregated held→acquired name graph (potential deadlocks)."""
    with _registry_lock:
        edges = dict(_edges)
    adj: dict[str, list[str]] = {}
    for src, dst in edges:
        adj.setdefault(src, []).append(dst)
    WHITE, GREY, BLACK = 0, 1, 2
    colour = {n: WHITE for n in adj}
    cycles: list[str] = []

    def visit(node: str, path: list[str]) -> None:
        colour[node] = GREY
        path.append(node)
        for nxt in adj.get(node, ()):
            if colour.get(nxt, WHITE) == GREY:
                loop = path[path.index(nxt):] + [nxt]
                where = edges.get((node, nxt), "?")
                cycles.append(
                    "lock-cycle: " + " -> ".join(loop) + f" (edge seen at {where})"
                )
            elif colour.get(nxt, WHITE) == WHITE and nxt in adj:
                visit(nxt, path)
            elif colour.get(nxt, WHITE) == WHITE:
                colour[nxt] = BLACK
        path.pop()
        colour[node] = BLACK

    for node in list(adj):
        if colour[node] == WHITE:
            visit(node, [])
    return cycles


def findings() -> list[str]:
    """All findings so far: rank violations, unguarded mutations, cycles."""
    with _registry_lock:
        out = list(_violations)
    out.extend(_graph_cycles())
    return out


def edges() -> dict[tuple[str, str], str]:
    with _registry_lock:
        return dict(_edges)


def export_edges(path: str) -> int:
    """Merge the current acquisition graph into a JSON edge file.

    The file accumulates across test runs (``dsflow --check-dynamic``
    consumes the union), so existing edges are kept and new ones merged in;
    the write is atomic (tmp + rename) because parallel pytest workers may
    export concurrently.  Returns the total edge count written.
    """
    import json

    merged: dict[tuple[str, str], str] = {}
    try:
        with open(path, encoding="utf-8") as f:
            prior = json.load(f)
        for rec in prior.get("edges", ()):
            merged[(rec["held"], rec["acquired"])] = rec.get("where", "?")
    except (OSError, ValueError, KeyError, TypeError):
        pass  # absent or torn file: start fresh
    for (held, acquired), where in edges().items():
        merged.setdefault((held, acquired), where)
    payload = {
        "edges": [
            {"held": h, "acquired": a, "where": w}
            for (h, a), w in sorted(merged.items())
        ]
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=1)
    os.replace(tmp, path)
    return len(merged)


# --------------------------------------------------------------------------
# instrumented locks
# --------------------------------------------------------------------------


class InstrumentedLock:
    """A named, rank-checked wrapper around ``threading.Lock``/``RLock``.

    Supports the subset of the lock API the core uses: ``with``,
    ``acquire``/``release``, ``locked``.  Reentrant acquisition is permitted
    iff the wrapped primitive is an RLock.
    """

    def __init__(self, name: str, *, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        # id(thread) → reentry depth; only ever touched by that thread for
        # its own key, so no extra synchronisation is needed.
        self._depth: dict[int, int] = {}

    # -- bookkeeping ------------------------------------------------------

    def held_by_current_thread(self) -> bool:
        return self._depth.get(threading.get_ident(), 0) > 0

    def _on_acquired(self) -> None:
        tid = threading.get_ident()
        depth = self._depth.get(tid, 0)
        self._depth[tid] = depth + 1
        if depth:  # reentrant re-acquisition: no new edge, no rank check
            return
        stack = _held_stack()
        my_rank = rank(self.name)
        where = _caller(depth=4)
        for held in stack:
            if held is self:
                continue
            with _registry_lock:
                _edges.setdefault((held.name, self.name), where)
            held_rank = rank(held.name)
            if my_rank is None or held_rank is None:
                continue  # unranked: cycle detection still covers it
            if my_rank <= held_rank:
                _record_violation(
                    f"lock-order: acquired {self.name} (rank {my_rank}) while "
                    f"holding {held.name} (rank {held_rank}) at {where}"
                )
        stack.append(self)

    def _on_released(self) -> None:
        tid = threading.get_ident()
        depth = self._depth.get(tid, 0)
        if depth <= 1:
            self._depth.pop(tid, None)
            stack = _held_stack()
            if self in stack:
                stack.remove(self)
        else:
            self._depth[tid] = depth - 1

    # -- lock API ---------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._on_acquired()
        return got

    def release(self) -> None:
        self._on_released()
        self._inner.release()

    def locked(self) -> bool:
        inner_locked = getattr(self._inner, "locked", None)
        if inner_locked is not None:
            return inner_locked()
        return bool(self._depth)

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<InstrumentedLock {self.name} reentrant={self.reentrant}>"


# --------------------------------------------------------------------------
# guarded shared state
# --------------------------------------------------------------------------


def _check_guard(guard: InstrumentedLock | None, label: str, op: str) -> None:
    if guard is None or not detect_enabled():
        return
    if not guard.held_by_current_thread():
        _record_violation(
            f"unguarded-mutation: {op} on {label} without holding "
            f"{guard.name} at {_caller(depth=4)}"
        )


class GuardedDict(dict):
    """A dict that flags mutations performed without its guard lock held.

    Reads are deliberately unchecked: the core's meters tolerate torn reads
    (they are monotone counters / rebuilt-on-save hop stats) and checking
    every read would swamp the report with benign findings.
    """

    def __init__(self, data, guard: InstrumentedLock | None, label: str):
        super().__init__(data)
        self._guard = guard
        self._label = label

    def __setitem__(self, key, value):
        _check_guard(self._guard, self._label, f"__setitem__({key!r})")
        super().__setitem__(key, value)

    def __delitem__(self, key):
        _check_guard(self._guard, self._label, f"__delitem__({key!r})")
        super().__delitem__(key)

    def update(self, *args, **kwargs):
        _check_guard(self._guard, self._label, "update")
        super().update(*args, **kwargs)

    def setdefault(self, key, default=None):
        if key not in self:
            _check_guard(self._guard, self._label, f"setdefault({key!r})")
        return super().setdefault(key, default)

    def pop(self, key, *default):
        _check_guard(self._guard, self._label, f"pop({key!r})")
        return super().pop(key, *default)

    def clear(self):
        _check_guard(self._guard, self._label, "clear")
        super().clear()

    def __reduce__(self):  # keep copy/deepcopy/pickle plain
        return (dict, (dict(self),))


class GuardedList(list):
    """A list that flags item assignment/append without its guard lock held."""

    def __init__(self, data, guard: InstrumentedLock | None, label: str):
        super().__init__(data)
        self._guard = guard
        self._label = label

    def __setitem__(self, index, value):
        _check_guard(self._guard, self._label, f"__setitem__({index!r})")
        super().__setitem__(index, value)

    def append(self, value):
        _check_guard(self._guard, self._label, "append")
        super().append(value)

    def extend(self, values):
        _check_guard(self._guard, self._label, "extend")
        super().extend(values)

    def pop(self, *args):
        _check_guard(self._guard, self._label, "pop")
        return super().pop(*args)

    def __reduce__(self):
        return (list, (list(self),))


def iter_findings() -> Iterator[str]:  # pragma: no cover - convenience
    yield from findings()
