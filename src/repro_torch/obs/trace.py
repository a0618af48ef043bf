"""Structured per-query tracing: span trees with instrument deltas.

The port of ``repro.obs.trace``.

A :class:`QueryTrace` is created by ``prov_query(..., trace=True)`` and
installed as ``log._active_trace`` for the duration of the query.  Hot
paths check ``self._active_trace is not None`` — a single attribute load
— so the tracing-off cost is effectively zero and is bounded by a
microbenchmark in the reference's ``tests/test_obs.py``.

Spans form a tree rooted at the ``query`` span.  Each span records wall
time (``perf_counter`` deltas) and, when a registry is attached, the
delta of every unlabeled counter that moved while the span was open.
Worker threads (``prov_query(..., parallel=N)``) have no span stack of
their own; their spans attach to the root, which keeps the tree
race-free without cross-thread coordination.

The span-stack lock is minted through ``repro_torch.core._locks`` (name
``trace._lock``, rank 90 — a leaf above ``metrics._lock``).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Iterator

__all__ = ["QueryTrace", "Span", "maybe_span"]


class Span:
    __slots__ = ("name", "kind", "attrs", "start", "duration", "delta", "children")

    def __init__(self, name: str, kind: str = "", attrs: dict | None = None) -> None:
        self.name = name
        self.kind = kind
        self.attrs = attrs or {}
        self.start = 0.0
        self.duration: float | None = None
        self.delta: dict[str, int] = {}
        self.children: list[Span] = []

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "attrs": self.attrs,
            "duration_ms": None if self.duration is None else self.duration * 1e3,
            "delta": self.delta,
            "children": [c.to_dict() for c in self.children],
        }

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()


class _NullSpan:
    """Throwaway span stand-in so untraced code can set ``sp.attrs``."""

    __slots__ = ("attrs",)

    def __init__(self) -> None:
        self.attrs: dict = {}


class _NullSpanCtx:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NullSpan()

    def __exit__(self, *exc) -> bool:
        return False


_NULL_CTX = _NullSpanCtx()


def maybe_span(trace: "QueryTrace | None", name: str, kind: str = "", **attrs):
    """``trace.span(...)`` when tracing, a no-op context otherwise."""
    if trace is None:
        return _NULL_CTX
    return trace.span(name, kind=kind, **attrs)


class QueryTrace:
    """Span tree for one query, with optional counter-delta capture."""

    def __init__(self, registry=None, label: str = "query") -> None:
        self._registry = registry
        from repro_torch.core import _locks  # lazy: core imports this module

        self._lock = _locks.new_lock("trace._lock")
        self._tls = threading.local()
        self.root = Span(label, kind="query")
        self.root.start = time.perf_counter()

    # -- span stack (per thread) -----------------------------------------

    def _stack(self) -> list[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def current(self) -> Span:
        stack = self._stack()
        return stack[-1] if stack else self.root

    def _attach(self, parent: Span, span: Span) -> None:
        with self._lock:
            parent.children.append(span)

    # -- recording API ----------------------------------------------------

    @contextmanager
    def span(self, name: str, kind: str = "", **attrs):
        """Open a child span; on exit record duration + counter deltas."""
        sp = Span(name, kind=kind, attrs=attrs)
        parent = self.current()
        stack = self._stack()
        stack.append(sp)
        before = self._registry.counters_flat() if self._registry is not None else None
        sp.start = time.perf_counter()
        try:
            yield sp
        finally:
            sp.duration = time.perf_counter() - sp.start
            if before is not None:
                after = self._registry.counters_flat()
                sp.delta = {
                    k: after[k] - before.get(k, 0)
                    for k in after
                    if after[k] != before.get(k, 0)
                }
            stack.pop()
            self._attach(parent, sp)

    def event(self, name: str, kind: str = "", duration: float | None = None, **attrs) -> Span:
        """Record a leaf span without opening a scope (for inline sites)."""
        sp = Span(name, kind=kind, attrs=attrs)
        sp.duration = duration
        self._attach(self.current(), sp)
        return sp

    def finish(self) -> "QueryTrace":
        if self.root.duration is None:
            self.root.duration = time.perf_counter() - self.root.start
        return self

    # -- inspection -------------------------------------------------------

    def spans(self, kind: str | None = None) -> list[Span]:
        return [s for s in self.root.walk() if kind is None or s.kind == kind]

    def kinds(self) -> set[str]:
        return {s.kind for s in self.root.walk() if s.kind}

    def to_dict(self) -> dict:
        return self.finish().root.to_dict()

    def render(self, max_depth: int = 8) -> str:
        """Indented tree view of the trace."""
        self.finish()
        lines: list[str] = []

        def fmt(span: Span, depth: int) -> None:
            if depth > max_depth:
                return
            dur = "" if span.duration is None else f" {span.duration * 1e3:.3f}ms"
            attrs = ""
            if span.attrs:
                attrs = " " + " ".join(f"{k}={v}" for k, v in span.attrs.items())
            delta = ""
            if span.delta:
                moved = ", ".join(f"{k}+{v}" for k, v in sorted(span.delta.items()))
                delta = f" [{moved}]"
            lines.append(f"{'  ' * depth}{span.name}{dur}{attrs}{delta}")
            for child in span.children:
                fmt(child, depth + 1)

        fmt(self.root, 0)
        return "\n".join(lines)
