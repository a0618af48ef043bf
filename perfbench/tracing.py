"""What the traced run (``--trace 1``) records, from the benchmark's side.

* Spans the harness opens around its calls into a layer (``span``): each
  is a ``record_function`` range named ``pb::<name>`` under the profiler,
  so the device timeline can be read against it.
* The calls ``core/query.py`` makes into ``kernels/ops.py``'s dense entry
  points (``range_join_pairs``, ``segmented_range_join_pairs``): wrapped, so
  each becomes an ``ops`` span (synchronised at exit) that keeps the join
  operands it handed the kernel, for the roofline.
* The planner's ``plan``/``execute`` calls, as labels on the timeline.
* ``torch.profiler`` over the window; :func:`timeline` reduces its trace,
  with the program's own ``dslog::`` ranges beside the harness's spans.

With tracing off every hook is a no-op and nothing is patched.
"""

from __future__ import annotations

import contextlib
import json
import re

import numpy as np


class Recorder:
    def __init__(self, enabled: bool, torch):
        self.enabled = enabled
        self.torch = torch
        self.launches: list[tuple[str, list]] = []  # (kernel, segments) per launch
        self._undo: list = []

    def span(self, name: str):
        """A ``pb::<name>`` range on the profiler's timeline, or a no-op."""
        if not self.enabled:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(f"pb::{name}")

    def _patch(self, obj, attr, make):
        orig = getattr(obj, attr)
        setattr(obj, attr, make(orig))
        self._undo.append((obj, attr, orig))

    def install(self, ops_mod, planner) -> None:
        """Wrap the ops entry points and the planner's calls (traced run only)."""
        if not self.enabled:
            return
        torch = self.torch

        def sync(device):
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()

        def pairs(orig):
            def wrapped(q_lo, q_hi, r_lo, r_hi, device="cuda"):
                with self.span("ops"):
                    out = orig(q_lo, q_hi, r_lo, r_hi, device=device)
                    sync(device)
                if q_lo.shape[0] and r_lo.shape[0]:
                    self.launches.append(("range_join_mask", [(q_lo, q_hi, r_lo, r_hi)]))
                return out
            return wrapped

        def segmented(orig):
            def wrapped(segments, *args, **kw):
                with self.span("ops"):
                    out, info = orig(segments, *args, **kw)
                    sync(kw.get("device", "cuda"))
                if info["launches"]:
                    kernel = ("range_join_tile_masks" if info["layout"] == "blockdiag"
                              else "range_join_mask")
                    self.launches.append((kernel, [tuple(s) for s in segments]))
                return out, info
            return wrapped

        def labelled(name):
            def make(orig):
                def wrapped(*args, **kw):
                    with torch.profiler.record_function(f"pb::{name}"):
                        return orig(*args, **kw)
                return wrapped
            return make

        self._patch(ops_mod, "range_join_pairs", pairs)
        self._patch(ops_mod, "segmented_range_join_pairs", segmented)
        for name in ("plan_path", "plan"):
            self._patch(planner, name, labelled("plan"))
        self._patch(planner, "execute", labelled("execute"))

    def uninstall(self) -> None:
        while self._undo:
            obj, attr, orig = self._undo.pop()
            setattr(obj, attr, orig)

    def profile(self):
        """The profiler over the window, or a no-op context."""
        if not self.enabled:
            return contextlib.nullcontext()
        acts = [self.torch.profiler.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(self.torch.profiler.ProfilerActivity.CUDA)
        return self.torch.profiler.profile(activities=acts)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def kernel_base(name: str) -> str:
    """A device op's name without its return type, template arguments and
    signature: ``void (anonymous namespace)::k<G>(int)`` reads ``k``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[len("void "):]
    return re.split(r"[<(]", n, maxsplit=1)[0].strip() or name


def _innermost(host: list[tuple[float, float, str]], w0: float, w1: float) -> list:
    """The window ``[w0, w1)`` cut into pieces ``(start, end, name)``, each
    under the innermost host span open over it (``harness`` where none is).
    ``host`` is sorted by start, the longer span first where two start
    together; spans of one thread nest."""
    pieces: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []  # (end, name) of the open spans, innermost last
    t = w0

    def upto(b: float, name: str) -> None:
        nonlocal t
        if b > t:
            if min(b, w1) > max(t, w0):
                pieces.append((max(t, w0), min(b, w1), name))
            t = b

    for s, e, name in host:
        while stack and stack[-1][0] <= s:
            upto(*stack.pop())
        upto(s, stack[-1][1] if stack else "harness")
        stack.append((e, name))
    while stack:
        upto(*stack.pop())
    upto(w1, "harness")
    return pieces


def timeline(events: list[dict]) -> dict:
    """Reduce a chrome trace's events (µs) to the device's busy time, the
    kernels' times, the idle time by the innermost host span the window's
    thread was in at each instant, and the ``ops`` spans' host time net of
    the kernels inside them.

    Host spans are the harness's ``pb::<name>`` ranges and the program's
    ``dslog::<name>`` ranges (``cpu_op`` events of ``prov_query(trace=True)``'s
    spans), each labelled by its name without the prefix: idle time reads
    ``query.canonical`` or ``ops.pack`` where the program opened such a
    span, ``execute`` or ``ops`` where only the harness's span was open,
    ``request`` inside a request outside both, ``harness`` between
    requests.  ``ops_s`` and ``ops_kernel_s`` come from the ``pb::ops``
    spans alone.

    The window is the ``pb::window`` range; device time is the union of
    kernel, copy and set intervals inside it."""
    win = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
           and e.get("name") == "pb::window"]
    if not win:
        return {}
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    tid = win[0].get("tid")
    host_ev = [e for e in events if e.get("ph") == "X" and e.get("tid") == tid and (
        (e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("pb::"))
        or (e.get("cat") == "cpu_op" and str(e.get("name", "")).startswith("dslog::")))]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and w0 <= e["ts"] < w1]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: dict[str, float] = {}
    count: dict[str, int] = {}
    for e in dev:
        k = kernel_base(e["name"]) if e["cat"] == "kernel" else e["name"]
        by_name[k] = by_name.get(k, 0.0) + e["dur"] * 1e-6
        count[k] = count.get(k, 0) + 1
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"].split("::", 1)[1]) for e in host_ev
                   if e["name"] != "pb::window"), key=lambda t: (t[0], -t[1]))
    pieces = _innermost(host, w0, w1)
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    i = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        # the pieces tile the window in order, and so do the idle intervals
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                name = pieces[j][2]
                gaps[name] = gaps.get(name, 0.0) + (hi - lo) * 1e-6
            j += 1
    ops_spans = [(e["ts"], e["ts"] + e["dur"]) for e in host_ev if e["name"] == "pb::ops"]
    ops_kernel = 0.0
    if ops_spans:
        k_starts = np.array([e["ts"] for e in kernels])
        k_durs = np.array([e["dur"] for e in kernels])
        order = np.argsort(k_starts)
        k_starts, k_durs = k_starts[order], k_durs[order]
        for s, e in ops_spans:
            i, j = np.searchsorted(k_starts, [s, e])
            ops_kernel += float(k_durs[i:j].sum()) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "device_s": by_name,
        "device_n": count,
        "idle_gaps": gaps,
        "ops_s": sum(e - s for s, e in ops_spans) * 1e-6,
        "ops_kernel_s": ops_kernel,
    }


def read_chrome_trace(path: str) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
