"""``dslint`` — AST lint pass for DSLog project invariants (layer 1).

The port's copy of ``repro.tools.dslint``: the same rules, on the port's
``astcache`` and lock table.  Rule scopes key on the path from the package
root, ``repro_torch`` or ``repro`` (``_scope_key``), so the two packages'
trees are linted alike.

Usage::

    python -m repro_torch.tools.dslint src/repro_torch   # lint a tree, exit 1 on findings
    python -m repro_torch.tools.dslint --list-rules
    python -m repro_torch.tools.dslint --json src/

The rules encode invariants the type system can't express:

``lock-context``
    Inside ``core/``, locks are only ever taken via ``with`` — explicit
    ``.acquire()`` / ``.release()`` on a lock-like attribute is an error
    (a raised exception between the two leaks the lock forever).
``lock-order``
    Syntactically nested ``with`` acquisitions must respect the declared
    rank table (``repro_torch.tools.lockorder``); a ``with`` on a lock-like
    attribute that is *not* in the table is itself a finding (the table
    must stay complete to mean anything).
``lock-new``
    ``core/`` constructs locks only through ``repro_torch.core._locks`` (so the
    dynamic race detector can substitute instrumented locks); direct
    ``threading.Lock()`` / ``threading.RLock()`` calls are errors outside
    ``_locks.py``.
``atomic-manifest``
    In the persistence modules (``core/catalog.py``, ``core/shard.py``)
    every *text*-mode write must go through ``_atomic_write`` (temp file +
    fsync + rename) — a plain ``open(path, "w")`` can tear a manifest.
``fsync-blob``
    In the same modules, a function that opens a file in ``"wb"`` mode must
    also fsync it before returning (blobs are referenced by a manifest that
    becomes visible atomically; the blob must hit stable storage first).
``bare-except``
    No ``except:`` without an exception type in ``core/``, ``kernels/``,
    ``tools/``.
``mutable-default``
    No mutable default arguments (``[]``, ``{}``, ``set()``, …) in
    ``core/``, ``kernels/``, ``tools/``.
``metric-registry``
    In ``core/``, instrument state lives in the store's
    :class:`~repro_torch.obs.metrics.MetricsRegistry`; writing through a
    legacy stats-dict attribute (``x.io_stats[...] = ...``,
    ``x.stats[...] += n``, ``x._io.update(...)``) bypasses the
    registry's lock and its exporters.  Mutate via ``metrics.inc`` /
    ``observe`` / ``set_gauge`` instead (``hop_stats`` is exempt: it is
    the planner's lock-guarded EMA table, not an instrument dict).
``int32-cast``
    In the kernel packers (``core/query.py``, ``kernels/``), a function
    performing ``.astype(np.int32)`` / ``.astype("int32")`` must reference
    one of the overflow guards (``_require_int32`` / ``fits_int32`` /
    ``int32_safe``) so the cast can never silently wrap.

Any finding can be suppressed on its line with ``# dslint: ignore[rule]``
(or a blanket ``# dslint: ignore``).  Rules are pluggable: call
:func:`register` with an object exposing ``name``, ``applies(scope)`` and
``check(ctx)`` before invoking :func:`lint_paths`.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
import time
from dataclasses import dataclass
from typing import Iterable, Iterator

from . import astcache
from .lockorder import STATIC_LOCKS, rank

_PRAGMA = re.compile(r"#\s*dslint:\s*ignore(?:\[(?P<rules>[\w\-, ]+)\])?")
_LOCKISH = re.compile(r"(?:lock|mutex)$", re.IGNORECASE)


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Context:
    """One file being linted: the shared parse (AST + node index) and the
    pragma map.  Rules query :meth:`nodes` instead of re-walking the tree,
    so one ``ast.walk`` serves every rule (``repro_torch.tools.astcache`` owns
    the parse, so ``dsflow`` runs over the same trees for free)."""

    def __init__(self, path: str, scope: str, parsed: astcache.ParsedFile):
        self.path = path
        self.scope = scope  # normalized repo-relative key, e.g. repro_torch/core/wal.py
        self.parsed = parsed
        self.source = parsed.source
        self.tree = parsed.tree
        self.ignores: dict[int, set[str] | None] = {}
        for lineno, line in enumerate(parsed.source.splitlines(), start=1):
            m = _PRAGMA.search(line)
            if m:
                rules = m.group("rules")
                self.ignores[lineno] = (
                    {r.strip() for r in rules.split(",")} if rules else None
                )

    def nodes(self, *types: type) -> tuple:
        """All nodes of the given exact AST classes (cached index)."""
        return self.parsed.by_type(*types)

    def suppressed(self, line: int, rule: str) -> bool:
        # a pragma suppresses its own line and the line directly below it
        # (for statements too long to carry a trailing comment)
        for at in (line, line - 1):
            if at in self.ignores:
                rules = self.ignores[at]
                if rules is None or rule in rules:
                    return True
        return False

    @property
    def module_stem(self) -> str:
        return os.path.splitext(os.path.basename(self.path))[0]

    def functions(self) -> Iterator[ast.AST]:
        yield from self.nodes(ast.FunctionDef, ast.AsyncFunctionDef)


def _in_dir(scope: str, *dirs: str) -> bool:
    parts = scope.split("/")
    return any(d in parts[:-1] for d in dirs)


def _is_lockish_expr(node: ast.expr) -> str | None:
    """The attribute name if ``node`` looks like a lock attribute access."""
    if isinstance(node, ast.Attribute) and _LOCKISH.search(node.attr):
        return node.attr
    if isinstance(node, ast.Name) and _LOCKISH.search(node.id):
        return node.id
    return None


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------

RULES: list = []


def register(rule) -> None:
    RULES.append(rule)


def _rule(cls):
    register(cls())
    return cls


@_rule
class LockContextRule:
    name = "lock-context"

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core") and not scope.endswith("_locks.py")

    def check(self, ctx: Context) -> Iterator[Finding]:
        for node in ctx.nodes(ast.Call):
            if not isinstance(node.func, ast.Attribute):
                continue
            if node.func.attr not in ("acquire", "release"):
                continue
            if _is_lockish_expr(node.func.value) is None:
                continue
            yield Finding(
                ctx.path,
                node.lineno,
                self.name,
                f"explicit .{node.func.attr}() on "
                f"{ast.unparse(node.func.value)}; acquire locks with "
                "'with' so exceptions cannot leak them",
            )


@_rule
class LockOrderRule:
    name = "lock-order"

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core") and not scope.endswith("_locks.py")

    def _lock_name(self, ctx: Context, item: ast.withitem) -> tuple[str | None, str | None]:
        """(declared name, attr) for a with-item that acquires a lock."""
        expr = item.context_expr
        attr = _is_lockish_expr(expr)
        if attr is None:
            return None, None
        return STATIC_LOCKS.get((ctx.module_stem, attr)), attr

    def check(self, ctx: Context) -> Iterator[Finding]:
        findings: list[Finding] = []

        def walk(node: ast.AST, held: tuple[tuple[str, int], ...]) -> None:
            for child in ast.iter_child_nodes(node):
                inner = held
                if isinstance(child, ast.With):
                    for item in child.items:
                        declared, attr = self._lock_name(ctx, item)
                        if attr is None:
                            continue
                        if declared is None:
                            findings.append(
                                Finding(
                                    ctx.path,
                                    child.lineno,
                                    self.name,
                                    f"lock-like attribute {attr!r} is not in "
                                    "the declared lock-order table "
                                    "(repro_torch.tools.lockorder); declare it or "
                                    "rename it",
                                )
                            )
                            continue
                        my_rank = rank(declared)
                        for held_name, held_rank in inner:
                            if my_rank is not None and my_rank <= held_rank:
                                findings.append(
                                    Finding(
                                        ctx.path,
                                        child.lineno,
                                        self.name,
                                        f"acquires {declared} (rank {my_rank}) "
                                        f"inside {held_name} (rank "
                                        f"{held_rank}); declared order is "
                                        "violated",
                                    )
                                )
                        if my_rank is not None:
                            inner = inner + ((declared, my_rank),)
                # function boundaries reset the held set: the static pass
                # only reasons about *syntactic* nesting (the dynamic layer
                # covers cross-call nesting)
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                    walk(child, ())
                else:
                    walk(child, inner)

        walk(ctx.tree, ())
        yield from findings


@_rule
class LockNewRule:
    name = "lock-new"

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core") and not scope.endswith("_locks.py")

    def check(self, ctx: Context) -> Iterator[Finding]:
        for node in ctx.nodes(ast.Call):
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr in ("Lock", "RLock")
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "threading"
            ):
                yield Finding(
                    ctx.path,
                    node.lineno,
                    self.name,
                    f"direct threading.{fn.attr}() in core/; mint locks via "
                    "repro.core._locks so the race detector can instrument "
                    "them",
                )


@_rule
class MetricRegistryRule:
    name = "metric-registry"

    # legacy instrument-dict attribute names; hop_stats is deliberately
    # absent (the planner's EMA table is guarded state, not a counter)
    _STATS_ATTRS = frozenset({"io_stats", "_io", "stats"})
    _MUTATORS = frozenset({"update", "setdefault", "pop", "popitem", "clear"})

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core")

    def _stats_attr(self, node: ast.expr) -> str | None:
        if isinstance(node, ast.Attribute) and node.attr in self._STATS_ATTRS:
            return node.attr
        return None

    def check(self, ctx: Context) -> Iterator[Finding]:
        for node in ctx.nodes(ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Call):
            targets: list[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                targets = [node.target]
            for tgt in targets:
                if not isinstance(tgt, ast.Subscript):
                    continue
                attr = self._stats_attr(tgt.value)
                if attr is not None:
                    yield Finding(
                        ctx.path,
                        node.lineno,
                        self.name,
                        f"direct write to {ast.unparse(tgt.value)}[...] "
                        "bypasses the metrics registry; use "
                        "metrics.inc/observe/set_gauge (the legacy "
                        f"{attr!r} surface is a read-only view)",
                    )
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in self._MUTATORS
                and self._stats_attr(node.func.value) is not None
            ):
                yield Finding(
                    ctx.path,
                    node.lineno,
                    self.name,
                    f".{node.func.attr}() on "
                    f"{ast.unparse(node.func.value)} bypasses the metrics "
                    "registry; use metrics.inc/observe/set_gauge",
                )


def _open_mode(node: ast.Call) -> str | None:
    """The literal mode string of an ``open()`` call, if discernible."""
    if not (isinstance(node.func, ast.Name) and node.func.id == "open"):
        return None
    mode: ast.expr | None = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None


@_rule
class AtomicManifestRule:
    name = "atomic-manifest"

    def applies(self, scope: str) -> bool:
        return scope.endswith(("core/catalog.py", "core/shard.py"))

    def check(self, ctx: Context) -> Iterator[Finding]:
        for fn in ctx.functions():
            if fn.name == "_atomic_write":
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                mode = _open_mode(node)
                if mode is None or "b" in mode or not any(c in mode for c in "wax"):
                    continue
                yield Finding(
                    ctx.path,
                    node.lineno,
                    self.name,
                    f"text-mode write (open mode {mode!r}) outside "
                    "_atomic_write; manifests must be written via temp file "
                    "+ fsync + atomic rename",
                )


@_rule
class FsyncBlobRule:
    name = "fsync-blob"

    def applies(self, scope: str) -> bool:
        return scope.endswith(("core/catalog.py", "core/shard.py"))

    def check(self, ctx: Context) -> Iterator[Finding]:
        for fn in ctx.functions():
            writes: list[int] = []
            fsyncs = False
            for node in ast.walk(fn):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node is not fn:
                    continue  # nested defs are visited on their own
                if isinstance(node, ast.Call):
                    mode = _open_mode(node)
                    if mode is not None and "b" in mode and any(c in mode for c in "wax"):
                        writes.append(node.lineno)
                    if (
                        isinstance(node.func, ast.Attribute)
                        and node.func.attr == "fsync"
                    ):
                        fsyncs = True
            if writes and not fsyncs:
                for line in writes:
                    yield Finding(
                        ctx.path,
                        line,
                        self.name,
                        f"binary write in {fn.name}() without an fsync; "
                        "manifest-referenced blobs must be durable before "
                        "the manifest rename publishes them",
                    )


@_rule
class BareExceptRule:
    name = "bare-except"

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core", "kernels", "tools")

    def check(self, ctx: Context) -> Iterator[Finding]:
        for node in ctx.nodes(ast.ExceptHandler):
            if node.type is None:
                yield Finding(
                    ctx.path,
                    node.lineno,
                    self.name,
                    "bare 'except:' swallows KeyboardInterrupt/SystemExit; "
                    "name the exceptions",
                )


@_rule
class MutableDefaultRule:
    name = "mutable-default"

    _MUTABLE_CALLS = ("list", "dict", "set", "bytearray")

    def applies(self, scope: str) -> bool:
        return _in_dir(scope, "core", "kernels", "tools")

    def _is_mutable(self, node: ast.expr) -> bool:
        if isinstance(node, (ast.List, ast.Dict, ast.Set)):
            return True
        return (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id in self._MUTABLE_CALLS
            and not node.args
            and not node.keywords
        )

    def check(self, ctx: Context) -> Iterator[Finding]:
        for fn in ctx.functions():
            for default in list(fn.args.defaults) + [
                d for d in fn.args.kw_defaults if d is not None
            ]:
                if self._is_mutable(default):
                    yield Finding(
                        ctx.path,
                        default.lineno,
                        self.name,
                        f"mutable default argument in {fn.name}(); use None "
                        "and construct inside the body",
                    )


@_rule
class Int32CastRule:
    name = "int32-cast"

    _GUARDS = ("_require_int32", "fits_int32", "int32_safe")

    def applies(self, scope: str) -> bool:
        return scope.endswith("core/query.py") or _in_dir(scope, "kernels")

    def _is_i32_cast(self, node: ast.Call) -> bool:
        if not (isinstance(node.func, ast.Attribute) and node.func.attr == "astype"):
            return False
        if not node.args:
            return False
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and arg.value == "int32":
            return True
        return (
            isinstance(arg, ast.Attribute)
            and arg.attr == "int32"
            and isinstance(arg.value, ast.Name)
            and arg.value.id in ("np", "numpy", "jnp")
        )

    def check(self, ctx: Context) -> Iterator[Finding]:
        for fn in ctx.functions():
            names = {
                n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
            } | {
                n.attr for n in ast.walk(fn) if isinstance(n, ast.Attribute)
            }
            guarded = any(g in names for g in self._GUARDS)
            if guarded:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and self._is_i32_cast(node):
                    yield Finding(
                        ctx.path,
                        node.lineno,
                        self.name,
                        f"astype(int32) in {fn.name}() with no overflow "
                        "guard in scope; call _require_int32/fits_int32 "
                        "first (silent wraparound corrupts packed "
                        "coordinates)",
                    )


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------


# the package roots a scoping key starts from: the port's and the reference's
_ROOTS = ("repro_torch", "repro")


def _scope_key(path: str) -> str:
    """Repo-relative rule-scoping key: the path from the last
    ``repro_torch`` or ``repro`` package root in it if present, else the
    path as given."""
    parts = path.replace(os.sep, "/").split("/")
    at = [i for i, part in enumerate(parts) if part in _ROOTS]
    return "/".join(parts[at[-1]:] if at else parts)


def iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if not d.startswith(".")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def lint_file(path: str) -> list[Finding]:
    scope = _scope_key(path)
    try:
        ctx = Context(path, scope, astcache.parse(path))
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, "syntax", str(exc))]
    out: list[Finding] = []
    for r in RULES:
        if not r.applies(scope):
            continue
        for finding in r.check(ctx):
            if not ctx.suppressed(finding.line, finding.rule):
                out.append(finding)
    out.sort(key=lambda f: (f.line, f.rule))
    return out


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    out: list[Finding] = []
    for path in iter_py_files(paths):
        out.extend(lint_file(path))
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.dslint",
        description="AST lint for DSLog project invariants",
    )
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument(
        "--stats", action="store_true", help="print file/timing stats to stderr"
    )
    args = ap.parse_args(argv)
    if args.list_rules:
        for r in RULES:
            print(r.name)
        return 0
    if not args.paths:
        ap.error("no paths given")
    t0 = time.perf_counter()
    files = list(iter_py_files(args.paths))
    findings = lint_paths(files)
    if args.stats:
        print(
            f"dslint stats: files={len(files)} rules={len(RULES)} "
            f"findings={len(findings)} "
            f"elapsed_s={time.perf_counter() - t0:.4f}",
            file=sys.stderr,
        )
    if args.json:
        print(
            json.dumps(
                [
                    {"path": f.path, "line": f.line, "rule": f.rule, "msg": f.message}
                    for f in findings
                ],
                indent=2,
            )
        )
    else:
        for f in findings:
            print(f)
        print(f"dslint: {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
