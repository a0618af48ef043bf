"""Structured per-query tracing: span trees with instrument deltas.

The port of ``repro.obs.trace``.

A :class:`QueryTrace` is created by ``prov_query(..., trace=True)`` and is
the process's *active* trace (:func:`active`) for the duration of the
query: :func:`activated` sets and clears it.  Code with no store handle —
``kernels/ops.py`` — reaches it through the same accessor as the
planner and the executor.  Every site opens its span through
:func:`span` (or :func:`spanned` for a whole function), which with no
active trace costs one global load and one ``None`` test: no
:class:`Span`, no object beyond the shared null context and no profiler
range is made.

Spans form a tree rooted at the ``query`` span.  Each span records wall
time (``perf_counter`` deltas).  The ``plan`` and ``execute`` spans
(``deltas=True``) also record the delta of every unlabeled counter of
the registry that moved while they were open; the finer spans do not,
so a traced query's cost does not grow with the number of spans.
Worker threads (``prov_query(..., parallel=N)``) have no span stack of
their own; their spans attach to the root, which keeps the tree
race-free without cross-thread coordination.  One traced query runs at a
time in a process: a query on another thread meanwhile adds its spans to
that trace's root.

The spans below ``execute``, with their kind and what each covers:

- ``planner.init`` (planner): the start frontier's ``merge_boxes``;
- ``query.prepare`` (query): validation, pooling and ``_unique_rows`` of
  one batched join;
- ``query.index`` (query): the interval index's probe and candidate
  estimate in the route decision, and its ``candidate_pairs``;
- ``query.route`` (query): which of a frontier's dense joins the kernel
  can take (lane capacity, the query side's int32 range and the table
  side's cached verdict);
- ``kernel_launch`` (kernel): the packed dispatch of a frontier's dense
  joins to ``ops.segmented_range_join_pairs``; ``twin`` (kernel): the
  numpy twin's evaluation of the segments the kernel does not take;
- ``ops.pack``, ``ops.upload``, ``ops.launch``, ``ops.extract`` (ops):
  in both dense entry points of ``kernels/ops.py``, the host packing and
  int32 checks (with a table side's one-time resident pack, its fill and
  upload included), the host-to-device copies of the packs, the kernel
  wrapper's call, and ``nonzero`` with the device-to-host copy and the
  host split of the pairs;
- ``query.finalize`` (query): de-relativized or inverted key boxes,
  scattered to their owners;
- ``planner.assemble`` (planner): a node's frontier, with the hop
  feedback and a ``merge_boxes`` per query;
- ``query.canonical`` (query): the targets' canonical cut, with the
  boxes it took and gave (``boxes_in``, ``boxes_out``).

While the autograd profiler records (``torch.profiler.profile``), each
span but the root is also a profiler range named ``dslog::<span name>``
(``torch.profiler.record_function``'s lighter C++ core, a ``cpu_op``
event in the trace), on the same timeline as the device's kernels and
copies.  :func:`timed` is the always-on stage timer of the
store's build (``ingest_seconds{stage=...}``), mirrored the same way.

The span-stack lock is minted through ``repro_torch.core._locks`` (name
``trace._lock``, rank 90 — a leaf above ``metrics._lock``).
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager
from typing import Iterator

__all__ = [
    "QueryTrace",
    "Span",
    "active",
    "activated",
    "maybe_span",
    "span",
    "spanned",
    "timed",
]

# the query being traced, or None (set and cleared by ``activated``)
_active: "QueryTrace | None" = None


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


class _Discard(dict):
    """Attributes set on the null span: dropped as they are written."""

    def __setitem__(self, key, value) -> None:
        pass

    def update(self, *args, **kwargs) -> None:
        pass


class _NullSpan:
    """The span untraced code sees, so it can set ``sp.attrs``."""

    __slots__ = ("attrs",)

    def __init__(self) -> None:
        self.attrs: dict = _Discard()


class _NullSpanCtx:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return _NULL_SPAN

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()
_NULL_CTX = _NullSpanCtx()


def active() -> "QueryTrace | None":
    """The trace of the query running now, or None."""
    return _active


@contextmanager
def activated(trace: "QueryTrace | None"):
    """Make ``trace`` the active trace for the block (no-op for None)."""
    global _active
    if trace is None:
        yield None
        return
    prev = _active
    _active = trace
    try:
        yield trace
    finally:
        _active = prev


def span(name: str, kind: str = ""):
    """A span of the active trace, or the shared null context."""
    tr = _active
    if tr is None:
        return _NULL_CTX
    return tr.span(name, kind)


def spanned(name: str, kind: str = ""):
    """Decorator: each call of the function is a span of the active trace
    (with none, one load and one ``None`` test before the call)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            tr = _active
            if tr is None:
                return fn(*args, **kwargs)
            with tr.span(name, kind):
                return fn(*args, **kwargs)

        return call

    return wrap


def maybe_span(trace: "QueryTrace | None", name: str, kind: str = "", **attrs):
    """``trace.span(...)`` when tracing, the shared null context otherwise."""
    if trace is None:
        return _NULL_CTX
    return trace.span(name, kind=kind, **attrs)


def _profiling() -> bool:
    """Whether the autograd profiler is recording."""
    import torch

    return bool(torch.autograd.profiler._is_profiler_enabled)


def _range(name: str):
    """An entered ``dslog::<name>`` range on the profiler's timeline (exit
    it with ``__exit__``): ``torch.profiler.record_function``'s C++ core
    without its two dispatcher ops.  Under the CPU and CUDA profiler on an
    H100 machine's host it costs about 0.5 µs a range against 9 µs for
    ``record_function``.  The trace lists these ranges as ``cpu_op``
    events."""
    import torch

    rf = torch._C._profiler._RecordFunctionFast(f"dslog::{name}")
    rf.__enter__()
    return rf


@contextmanager
def timed(registry, metric: str, stage: str):
    """Observe the block's wall seconds into ``registry``'s histogram
    ``metric{stage=...}``; always on.  While the profiler records, the
    block is a ``dslog::<metric without _seconds>.<stage>`` range too."""
    rf = _range(f"{metric.removesuffix('_seconds')}.{stage}") if _profiling() else None
    t0 = time.perf_counter()
    try:
        yield
    finally:
        registry.observe(metric, time.perf_counter() - t0, stage=stage)
        if rf is not None:
            rf.__exit__(None, None, None)


class _SpanScope:
    """One open span of a :class:`QueryTrace` (its ``with`` block)."""

    __slots__ = ("trace", "span", "deltas", "parent", "stack", "before", "rf")

    def __init__(self, trace: "QueryTrace", span: Span, deltas: bool) -> None:
        self.trace, self.span, self.deltas = trace, span, deltas

    def __enter__(self) -> Span:
        tr, sp = self.trace, self.span
        self.stack = stack = tr._stack()
        self.parent = stack[-1] if stack else tr.root
        stack.append(sp)
        self.before = (
            tr._registry.counters_flat()
            if self.deltas and tr._registry is not None
            else None
        )
        self.rf = _range(sp.name) if tr._mirror else None
        sp.start = time.perf_counter()
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self.span
        sp.duration = time.perf_counter() - sp.start
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        if self.before is not None:
            after = self.trace._registry.counters_flat()
            before = self.before
            sp.delta = {
                k: after[k] - before.get(k, 0)
                for k in after
                if after[k] != before.get(k, 0)
            }
        self.stack.pop()
        self.trace._attach(self.parent, sp)
        return False


class QueryTrace:
    """Span tree for one query, with optional counter-delta capture."""

    def __init__(self, registry=None, label: str = "query") -> None:
        self._registry = registry
        from repro_torch.core import _locks  # lazy: core imports this module

        self._lock = _locks.new_lock("trace._lock")
        self._tls = threading.local()
        # mirror spans onto the profiler's timeline while it records
        self._mirror = _profiling()
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

    def span(self, name: str, kind: str = "", deltas: bool = False, **attrs) -> "_SpanScope":
        """Open a child span; on exit record its duration and, with
        ``deltas``, the counters that moved."""
        return _SpanScope(self, Span(name, kind=kind, attrs=attrs), deltas)

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
