"""``dsflow`` — interprocedural lock/effect analysis (layer 1.5).

The port's copy of ``repro.tools.dsflow``, on the port's ``astcache``,
``dslint`` scoping, finding schema and lock table.

Usage::

    python -m repro_torch.tools.dsflow src/repro_torch     # exit 1 on findings
    python -m repro_torch.tools.dsflow src/repro_torch --json
    python -m repro_torch.tools.dsflow src/repro_torch --baseline tools/dsflow_baseline.json
    python -m repro_torch.tools.dsflow src/repro_torch --check-dynamic /tmp/lockgraph.json

Where ``dslint`` reasons one statement at a time and the
``DSLOG_RACE_DETECT=1`` detector only sees interleavings the tests happen
to execute, ``dsflow`` builds a module/class-aware call graph over the
analyzed tree, computes a per-function **effect summary** — locks acquired
(resolved through :mod:`repro_torch.tools.lockorder`), blocking I/O
(``fsync``/``flock``/``rename``/``sleep``/socket ops), WAL appends and
truncations, metrics-registry mutations, escaping exceptions — and
propagates the summaries to a fixpoint through call chains, callback
parameters (``manifest_chunk(write_blob)``), thread targets
(``threading.Thread(target=...)``, ``pool.submit(...)``) and
method-object aliases (``_wal_emit = DSLog._wal_emit``).  Rule classes:

``lock-order``
    A call path acquires a lock ranked at or below one already held —
    the transitive generalisation of dslint's syntactic rule.
``lock-fsync``
    Blocking I/O reachable while holding any core lock.  The group-commit
    barrier ``commit._flush_mutex`` is exempt by design (it exists to be
    held across the WAL flush); every other deliberate site carries a
    justified pragma.
``wal-lease``
    A public ``core/`` entry point reaches a WAL append/truncate with no
    lease check anywhere on the path.
``lock-cycle``
    A cycle in the static held→acquired lock graph (a latent deadlock
    across thread entry points even when every individual edge is legal).
``registry-lock``
    A ``MetricsRegistry`` instrument-table mutation outside
    ``metrics._lock``.

Any finding can be suppressed on its line (or the line above) with
``# dsflow: ignore[rule]``; a pragma on a blocking op / call site also
stops that fact from propagating to callers, so one pragma at a deliberate
site silences the whole cone above it.  ``--baseline FILE`` fails only on
findings not recorded in the baseline; ``--write-baseline`` records the
current findings.  ``--check-dynamic FILE`` asserts every lock edge the
dynamic detector exported (:func:`repro_torch.tools.racecheck.export_edges`) is
present in the static graph — a dynamic-only edge means the call-graph
builder has a blind spot.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
import time
from dataclasses import dataclass, field

from . import astcache
from .dslint import _in_dir, _scope_key, iter_py_files
from .findings import finding_dict
from .lockorder import LOCK_ORDER, STATIC_LOCKS

_PRAGMA = re.compile(r"#\s*dsflow:\s*ignore(?:\[(?P<rules>[\w\-, ]+)\])?")
_LOCKISH = re.compile(r"(?:lock|mutex)$", re.IGNORECASE)

RULE_NAMES = (
    "lock-order",
    "lock-fsync",
    "wal-lease",
    "lock-cycle",
    "registry-lock",
)

# dotted call → blocking-I/O kind (the classes of op that serialize a hot
# lock behind disk/kernel latency)
_BLOCKING_CALLS = {
    "os.fsync": "fsync",
    "os.fdatasync": "fsync",
    "fcntl.flock": "flock",
    "fcntl.lockf": "flock",
    "os.rename": "rename",
    "os.replace": "rename",
    "time.sleep": "sleep",
    # network ops that actually block (local lookups like gethostname are
    # trivial syscalls and deliberately absent)
    "socket.create_connection": "socket",
    "socket.getaddrinfo": "socket",
    "socket.gethostbyname": "socket",
}

# method names too generic for receiver-less fallback resolution (every
# list has .append; resolving it to WriteAheadLog.append would poison the
# whole graph)
_GENERIC_METHODS = frozenset(
    {
        "append", "add", "pop", "get", "update", "clear", "remove",
        "extend", "insert", "discard", "setdefault", "items", "keys",
        "values", "copy", "close", "flush", "read", "write", "open",
        "save", "load", "reset", "run", "start", "join", "submit",
        "put", "send", "acquire", "release", "wait", "notify", "index",
        "count", "sort", "split", "strip", "encode", "decode", "format",
        "search", "match", "group", "sub", "findall", "exists", "mkdir",
        "unlink", "name", "stat", "render", "describe", "todo",
    }
)

_LEASE_ATTRS = frozenset(
    {"_lease", "_root_lease", "_presence_lease", "_shard_leases"}
)
_WAL_CLASS = "WriteAheadLog"
_LEASE_CLASS = "WriterLease"
_REGISTRY_CLASS = "MetricsRegistry"
_REGISTRY_ATTRS = frozenset(
    {"_counters", "_gauges", "_histograms", "_collectors"}
)
_DICT_MUTATORS = frozenset(
    {"update", "setdefault", "pop", "popitem", "clear", "append"}
)


@dataclass
class Finding:
    path: str
    line: int
    rule: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_dict(self) -> dict:
        return finding_dict(
            "dsflow", self.rule, self.severity, self.path, self.line,
            self.message,
        )


@dataclass
class CallSite:
    line: int
    held: tuple
    targets: set
    node: ast.Call
    suppressed: frozenset
    pending_param: str = ""
    skip_self: bool = True


@dataclass
class FuncInfo:
    qual: str
    name: str
    path: str
    scope: str
    stem: str
    lineno: int
    node: ast.AST
    cls: str = ""          # owning (or enclosing, for nested defs) class
    parent: str = ""       # enclosing function qual for nested defs
    is_method: bool = True  # False for nested defs / staticmethods
    is_property: bool = False
    params: list = field(default_factory=list)
    returns: set = field(default_factory=set)
    nested: dict = field(default_factory=dict)   # local def name → qual
    acquires: list = field(default_factory=list)  # (held, lock, line)
    blocking: list = field(default_factory=list)  # (kind, line, held)
    wal_direct: list = field(default_factory=list)  # (kind, line)
    registry_mut: list = field(default_factory=list)  # (line, held)
    raises: set = field(default_factory=set)
    lease_check: bool = False
    intrinsic_wal: str = ""
    calls: list = field(default_factory=list)
    thread_entry: bool = False


@dataclass
class ClassInfo:
    name: str
    stem: str
    qual: str
    scope: str
    bases: list = field(default_factory=list)
    methods: dict = field(default_factory=dict)     # name → func qual
    aliases: dict = field(default_factory=dict)     # name → borrowed qual
    properties: set = field(default_factory=set)
    attr_types: dict = field(default_factory=dict)  # attr → set of types
    # attr → (storing function qual, param name): callbacks kept on the
    # instance (``self._on_load = on_load``), resolved against the
    # functions bound to that param at construction sites
    callback_attrs: dict = field(default_factory=dict)


@dataclass
class ModuleInfo:
    path: str
    scope: str
    stem: str
    tree: ast.Module
    imports_ext: dict = field(default_factory=dict)   # name → dotted module
    module_aliases: dict = field(default_factory=dict)  # name → module stem
    from_names: dict = field(default_factory=dict)    # name → (stem, orig)
    functions: dict = field(default_factory=dict)     # name → qual
    classes: dict = field(default_factory=dict)       # name → ClassInfo
    pragmas: dict = field(default_factory=dict)       # line → set|None


def _pragma_map(source: str) -> dict:
    out: dict = {}
    for lineno, line in enumerate(source.splitlines(), start=1):
        m = _PRAGMA.search(line)
        if m:
            rules = m.group("rules")
            out[lineno] = (
                {r.strip() for r in rules.split(",")} if rules else None
            )
    return out


def _suppressed_rules(pragmas: dict, line: int) -> frozenset:
    """Rules suppressed at ``line`` (its own pragma or the line above's).
    A blanket pragma suppresses every rule."""
    out: set = set()
    for at in (line, line - 1):
        rules = pragmas.get(at, ())
        if rules is None:
            return frozenset(RULE_NAMES)
        out.update(rules)
    return frozenset(out)


def _ann_types(node) -> set:
    """Class names named by an annotation expression (``X``, ``"X"``,
    ``X | None``, ``Optional[X]``, ``list[X]`` → ``list:X``, …)."""
    if node is None:
        return set()
    if isinstance(node, ast.Name):
        return set() if node.id == "None" else {node.id}
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            try:
                return _ann_types(ast.parse(node.value, mode="eval").body)
            except SyntaxError:
                return set()
        return set()
    if isinstance(node, ast.Attribute):
        return {node.attr}
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _ann_types(node.left) | _ann_types(node.right)
    if isinstance(node, ast.Subscript):
        base = node.value
        inner = _ann_types(node.slice)
        if isinstance(node.slice, ast.Tuple):
            inner = set()
            for elt in node.slice.elts:
                inner |= _ann_types(elt)
        if isinstance(base, ast.Name):
            if base.id == "Optional":
                return inner
            if base.id in ("list", "List", "Sequence", "Iterable",
                           "tuple", "Tuple", "set", "Set", "frozenset"):
                return {f"list:{t}" for t in inner if ":" not in t}
            if base.id in ("dict", "Dict", "Mapping", "MutableMapping"):
                # value type only (keys are never receivers here)
                vals = (
                    _ann_types(node.slice.elts[-1])
                    if isinstance(node.slice, ast.Tuple) and node.slice.elts
                    else inner
                )
                return {f"list:{t}" for t in vals if ":" not in t}
        return set()
    return set()


def _elem_types(types: set) -> set:
    return {t.split(":", 1)[1] for t in types if t.startswith("list:")}


class Analysis:
    """The result of one :func:`analyze_paths` run."""

    def __init__(self, lock_order, static_locks, reentrant, hot_locks):
        self.lock_order = lock_order
        self.static_locks = static_locks
        self.reentrant = set(reentrant)
        self.hot_locks = set(hot_locks)
        self.modules: dict = {}
        self.functions: dict = {}
        self.classes_by_name: dict = {}
        self.findings: list = []
        # (held, acquired) → (path, line, chain tuple)
        self.lock_edges: dict = {}
        self.stats: dict = {}

    def rank(self, name: str):
        return self.lock_order.get(name)

    def static_edges(self) -> set:
        return set(self.lock_edges)

    def check_dynamic(self, edges) -> list:
        """Findings for dynamically observed edges missing from the static
        graph.  ``edges`` is an iterable of ``{"held", "acquired",
        "where"}`` records (see :func:`repro_torch.tools.racecheck.export_edges`).
        Only edges between *declared* locks are checked — tests mint
        scratch locks with arbitrary names the static pass can't know."""
        static = self.static_edges()
        out = []
        for rec in edges:
            held, acq = rec.get("held", ""), rec.get("acquired", "")
            if held not in self.lock_order or acq not in self.lock_order:
                continue
            if held == acq or (held, acq) in static:
                continue
            out.append(
                Finding(
                    rec.get("where", "?"),
                    0,
                    "dynamic-uncovered",
                    f"dynamic lock edge {held} -> {acq} (seen at "
                    f"{rec.get('where', '?')}) is missing from the static "
                    "lock graph; the call-graph builder has a blind spot",
                )
            )
        return out

    def to_json(self) -> dict:
        return {
            "tool": "dsflow",
            "findings": [f.to_dict() for f in self.findings],
            "lock_edges": sorted(
                [list(k) for k in self.lock_edges], key=tuple
            ),
            "functions": len(self.functions),
            "stats": dict(self.stats),
        }


class _Engine:
    def __init__(self, analysis: Analysis):
        self.a = analysis
        self.param_bindings: dict = {}   # (func qual, param) → set of quals
        self.t_acq: dict = {}    # qual → {lock: (line, next qual|None)}
        self.t_block: dict = {}  # qual → {kind: (line, next qual|None)}
        self.u_wal: dict = {}    # qual → (line, next qual|None, kind)

    # ------------------------------------------------------------------ #
    # phase 1: index modules, classes, functions
    # ------------------------------------------------------------------ #
    def index_module(self, path: str) -> None:
        parsed = astcache.parse(path)
        scope = _scope_key(path)
        stem = os.path.splitext(os.path.basename(path))[0]
        mod = ModuleInfo(path, scope, stem, parsed.tree)
        mod.pragmas = _pragma_map(parsed.source)
        self.a.modules[stem] = mod
        for node in parsed.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    mod.imports_ext[local] = alias.name
                    mod.module_aliases[local] = alias.name.split(".")[-1]
            elif isinstance(node, ast.ImportFrom):
                src = node.module or ""
                for alias in node.names:
                    local = alias.asname or alias.name
                    if node.level and not node.module:
                        # from . import wal
                        mod.module_aliases[local] = alias.name
                    else:
                        mod.from_names[local] = (
                            src.split(".")[-1], alias.name
                        )
                        mod.imports_ext[local] = f"{src}.{alias.name}"
        self._index_body(mod, parsed.tree.body, stem, None, None)

    def _index_body(self, mod, body, prefix, cls, parent_fn):
        for node in body:
            if isinstance(node, ast.ClassDef):
                ci = ClassInfo(
                    node.name, mod.stem, f"{prefix}.{node.name}", mod.scope
                )
                for base in node.bases:
                    if isinstance(base, ast.Name):
                        ci.bases.append(base.id)
                    elif isinstance(base, ast.Attribute):
                        ci.bases.append(base.attr)
                mod.classes[node.name] = ci
                self.a.classes_by_name.setdefault(node.name, []).append(ci)
                self._index_class_body(mod, node, ci)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._index_func(mod, node, prefix, cls, parent_fn)

    def _index_class_body(self, mod, node, ci):
        for st in node.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._index_func(mod, st, ci.qual, ci, None)
                ci.methods[st.name] = fi.qual
                if fi.is_property:
                    ci.properties.add(st.name)
            elif isinstance(st, ast.Assign) and len(st.targets) == 1:
                tgt = st.targets[0]
                if isinstance(tgt, ast.Name):
                    ref = st.value
                    if (
                        isinstance(ref, ast.Call)
                        and isinstance(ref.func, ast.Name)
                        and ref.func.id == "staticmethod"
                        and ref.args
                    ):
                        ref = ref.args[0]
                    if isinstance(ref, ast.Attribute) and isinstance(
                        ref.value, ast.Name
                    ):
                        # `_wal_emit = DSLog._wal_emit` — borrowed method
                        ci.aliases[tgt.id] = (ref.value.id, ref.attr)
            elif isinstance(st, ast.AnnAssign) and isinstance(
                st.target, ast.Name
            ):
                ci.attr_types.setdefault(st.target.id, set()).update(
                    _ann_types(st.annotation)
                )

    def _index_func(self, mod, node, prefix, cls, parent_fn) -> FuncInfo:
        qual = f"{prefix}.{node.name}"
        decorators = set()
        for dec in node.decorator_list:
            if isinstance(dec, ast.Name):
                decorators.add(dec.id)
            elif isinstance(dec, ast.Attribute):
                decorators.add(dec.attr)
        args = node.args
        params = [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]
        fi = FuncInfo(
            qual=qual,
            name=node.name,
            path=mod.path,
            scope=mod.scope,
            stem=mod.stem,
            lineno=node.lineno,
            node=node,
            cls=(cls.name if cls else (parent_fn.cls if parent_fn else "")),
            parent=(parent_fn.qual if parent_fn else ""),
            is_method=(cls is not None and "staticmethod" not in decorators),
            is_property=(
                bool({"property", "cached_property"} & decorators)
            ),
            params=params,
            returns=_ann_types(node.returns),
        )
        self.a.functions[qual] = fi
        if parent_fn is not None:
            parent_fn.nested[node.name] = qual
        elif cls is None:
            mod.functions[node.name] = qual
        if cls is not None and cls.name == _WAL_CLASS:
            if node.name == "append":
                fi.intrinsic_wal = "wal-append"
            elif node.name in ("checkpoint", "repair"):
                fi.intrinsic_wal = "wal-truncate"
        # nested defs (and defs inside methods) become their own functions
        for st in ast.walk(node):
            if (
                isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
                and st is not node
                and self._direct_parent_func(node, st)
            ):
                self._index_func(mod, st, qual, None, fi)
        return fi

    @staticmethod
    def _direct_parent_func(parent, child) -> bool:
        """True when ``child`` def's nearest enclosing def is ``parent``."""
        stack = [(parent, iter(ast.iter_child_nodes(parent)))]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                stack.pop()
                continue
            if nxt is child:
                return node is parent
            if isinstance(nxt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                stack.append((nxt, iter(ast.iter_child_nodes(nxt))))
            else:
                stack.append((node, iter(ast.iter_child_nodes(nxt))))
        return False

    # ------------------------------------------------------------------ #
    # phase 2: resolve class aliases + attribute types + relatedness
    # ------------------------------------------------------------------ #
    def link_classes(self) -> None:
        for mod in self.a.modules.values():
            for ci in mod.classes.values():
                resolved = {}
                for name, (src_cls, attr) in ci.aliases.items():
                    owner = self._class_by_name(mod, src_cls)
                    if owner is not None and attr in owner.methods:
                        resolved[name] = owner.methods[attr]
                ci.aliases = resolved
        # borrowed-method relatedness: `self.x()` inside DSLog code may run
        # with a ShardedDSLog receiver when Sharded borrows DSLog methods
        self._borrowers: dict = {}
        for mod in self.a.modules.values():
            for ci in mod.classes.values():
                for target in ci.aliases.values():
                    owner = self.a.functions.get(target)
                    if owner is not None and owner.cls:
                        self._borrowers.setdefault(owner.cls, set()).add(
                            ci.name
                        )
        # self-attribute types from every method body
        for mod in self.a.modules.values():
            for ci in mod.classes.values():
                for qual in ci.methods.values():
                    fi = self.a.functions.get(qual)
                    if fi is None:
                        continue
                    for st in ast.walk(fi.node):
                        tgt = None
                        ann = None
                        value = None
                        if isinstance(st, ast.Assign) and len(st.targets) == 1:
                            tgt, value = st.targets[0], st.value
                        elif isinstance(st, ast.AnnAssign):
                            tgt, ann, value = st.target, st.annotation, st.value
                        if not (
                            isinstance(tgt, ast.Attribute)
                            and isinstance(tgt.value, ast.Name)
                            and tgt.value.id == "self"
                        ):
                            continue
                        types = ci.attr_types.setdefault(tgt.attr, set())
                        if ann is not None:
                            types.update(_ann_types(ann))
                        if isinstance(value, ast.Call):
                            c = self._call_ctor_class(mod, value)
                            if c:
                                types.add(c)
                        # a parameter stashed on the instance: the attr
                        # inherits the param's annotated types, and later
                        # ``self._attr()`` calls dispatch to whatever
                        # callables construction sites bound to the param
                        if (
                            isinstance(value, ast.Name)
                            and value.id in fi.params
                        ):
                            ci.callback_attrs.setdefault(
                                tgt.attr, (fi.qual, value.id)
                            )
                            fargs = fi.node.args
                            for a in (
                                fargs.posonlyargs + fargs.args
                                + fargs.kwonlyargs
                            ):
                                if (
                                    a.arg == value.id
                                    and a.annotation is not None
                                ):
                                    types.update(_ann_types(a.annotation))

    def _call_ctor_class(self, mod, call) -> str:
        fn = call.func
        name = None
        if isinstance(fn, ast.Name):
            name = fn.id
        elif isinstance(fn, ast.Attribute):
            name = fn.attr
        if name and name in self.a.classes_by_name:
            return name
        return ""

    def _class_by_name(self, mod, name: str):
        if name in mod.classes:
            return mod.classes[name]
        if name in mod.from_names:
            stem, orig = mod.from_names[name]
            src = self.a.modules.get(stem)
            if src is not None and orig in src.classes:
                return src.classes[orig]
        hits = self.a.classes_by_name.get(name, [])
        return hits[0] if len(hits) == 1 else None

    def _subclasses(self, name: str) -> set:
        out = set()
        for cname, infos in self.a.classes_by_name.items():
            for ci in infos:
                if name in ci.bases:
                    out.add(cname)
                    out |= self._subclasses(cname) if cname != name else set()
        return out

    def _resolve_method(self, ci: ClassInfo, m: str, depth: int = 0) -> str:
        if depth > 8 or ci is None:
            return ""
        if m in ci.methods:
            return ci.methods[m]
        if m in ci.aliases:
            return ci.aliases[m]
        mod = self.a.modules.get(ci.stem)
        for base in ci.bases:
            bci = self._class_by_name(mod, base) if mod else None
            if bci is not None and bci is not ci:
                got = self._resolve_method(bci, m, depth + 1)
                if got:
                    return got
        return ""

    # ------------------------------------------------------------------ #
    # phase 3: per-function fact collection
    # ------------------------------------------------------------------ #
    def collect_all(self) -> None:
        for fi in list(self.a.functions.values()):
            _FactCollector(self, fi).run()

    # ------------------------------------------------------------------ #
    # phase 4: callback-parameter binding fixpoint
    # ------------------------------------------------------------------ #
    def bind_params(self) -> None:
        for _ in range(6):
            changed = self._bind_round()
            if not changed:
                break

    def _bind_round(self) -> bool:
        changed = False
        # collect bindings from every resolved call's function-ref args
        for fi in self.a.functions.values():
            for cs in fi.calls:
                for target in list(cs.targets):
                    ti = self.a.functions.get(target)
                    if ti is None:
                        continue
                    params = list(ti.params)
                    if (
                        cs.skip_self
                        and ti.is_method
                        and params
                        and params[0] in ("self", "cls")
                    ):
                        params = params[1:]
                    mod = self.a.modules.get(fi.stem)
                    for i, arg in enumerate(cs.node.args):
                        if i >= len(params):
                            break
                        ref = self._func_ref(fi, mod, arg)
                        if ref and ref not in self.param_bindings.setdefault(
                            (ti.qual, params[i]), set()
                        ):
                            self.param_bindings[(ti.qual, params[i])].add(ref)
                            changed = True
                    for kw in cs.node.keywords:
                        if kw.arg is None or kw.arg not in ti.params:
                            continue
                        ref = self._func_ref(fi, mod, kw.value)
                        if ref and ref not in self.param_bindings.setdefault(
                            (ti.qual, kw.arg), set()
                        ):
                            self.param_bindings[(ti.qual, kw.arg)].add(ref)
                            changed = True
        # resolve pending param-name calls against the bindings
        for fi in self.a.functions.values():
            for cs in fi.calls:
                if not cs.pending_param:
                    continue
                if "::" in cs.pending_param:
                    # attribute-stored callback: bound at the storing
                    # function (usually __init__), not at this caller
                    key = tuple(cs.pending_param.split("::", 1))
                else:
                    key = (fi.qual, cs.pending_param)
                bound = self.param_bindings.get(key, ())
                for ref in bound:
                    if ref not in cs.targets:
                        cs.targets.add(ref)
                        changed = True
        return changed

    def _func_ref(self, fi: FuncInfo, mod, arg) -> str:
        """The function qual an argument expression refers to, if any."""
        if isinstance(arg, ast.Name):
            if arg.id in fi.nested:
                return fi.nested[arg.id]
            parent = self.a.functions.get(fi.parent)
            if parent is not None and arg.id in parent.nested:
                return parent.nested[arg.id]
            if mod is not None and arg.id in mod.functions:
                return mod.functions[arg.id]
        if isinstance(arg, ast.Attribute) and isinstance(arg.value, ast.Name):
            if arg.value.id in ("self", "cls") and fi.cls:
                ci = self._class_by_name(
                    self.a.modules.get(fi.stem), fi.cls
                )
                if ci is not None:
                    return self._resolve_method(ci, arg.attr)
        return ""

    # ------------------------------------------------------------------ #
    # phase 5: effect fixpoint
    # ------------------------------------------------------------------ #
    def propagate(self) -> None:
        for fi in self.a.functions.values():
            acq = {}
            for held, lock, line in fi.acquires:
                acq.setdefault(lock, (line, None))
            self.t_acq[fi.qual] = acq
            blk = {}
            for kind, line, _held in fi.blocking:
                blk.setdefault(kind, (line, None))
            self.t_block[fi.qual] = blk
            if fi.intrinsic_wal:
                self.u_wal[fi.qual] = (fi.lineno, None, fi.intrinsic_wal)
            for kind, line in fi.wal_direct:
                self.u_wal.setdefault(fi.qual, (line, None, kind))
        for _ in range(64):
            changed = False
            for fi in self.a.functions.values():
                acq = self.t_acq[fi.qual]
                blk = self.t_block[fi.qual]
                for cs in fi.calls:
                    for t in cs.targets:
                        if t not in self.t_acq:
                            continue
                        for lock in self.t_acq[t]:
                            if lock not in acq:
                                acq[lock] = (cs.line, t)
                                changed = True
                        if "lock-fsync" not in cs.suppressed:
                            for kind in self.t_block[t]:
                                if kind not in blk:
                                    blk[kind] = (cs.line, t)
                                    changed = True
                        if "wal-lease" not in cs.suppressed:
                            w = self.u_wal.get(t)
                            ti = self.a.functions.get(t)
                            if (
                                w is not None
                                and ti is not None
                                and not ti.lease_check
                                and fi.qual not in self.u_wal
                            ):
                                self.u_wal[fi.qual] = (cs.line, t, w[2])
                                changed = True
            if not changed:
                break

    def _chain(self, start: str, key, table) -> list:
        names = [start]
        cur = start
        for _ in range(25):
            entry = table.get(cur, {}).get(key) if key is not None else (
                table.get(cur)
            )
            if entry is None:
                break
            nxt = entry[1]
            if nxt is None:
                break
            names.append(nxt)
            cur = nxt
        return names

    # ------------------------------------------------------------------ #
    # phase 6: rules
    # ------------------------------------------------------------------ #
    def report(self) -> None:
        findings: list = []
        self._rule_lock_order(findings)
        self._rule_lock_fsync(findings)
        self._rule_wal_lease(findings)
        self._rule_lock_cycle(findings)
        self._rule_registry_lock(findings)
        # line-level pragma filter (same semantics as dslint: own line or
        # the line above)
        out = []
        seen = set()
        for f in findings:
            mod = self._module_for_path(f.path)
            if mod is not None:
                sup = _suppressed_rules(mod.pragmas, f.line)
                if f.rule in sup:
                    continue
            key = (f.path, f.line, f.rule, f.message)
            if key in seen:
                continue
            seen.add(key)
            out.append(f)
        out.sort(key=lambda f: (f.path, f.line, f.rule))
        self.a.findings.extend(out)

    def _module_for_path(self, path: str):
        for mod in self.a.modules.values():
            if mod.path == path:
                return mod
        return None

    def _add_edge(self, held: str, acquired: str, path, line, chain) -> None:
        if held == acquired and held in self.a.reentrant:
            return
        self.a.lock_edges.setdefault(
            (held, acquired), (path, line, tuple(chain))
        )

    def _rule_lock_order(self, findings: list) -> None:
        a = self.a
        for fi in a.functions.values():
            for held, lock, line in fi.acquires:
                for h in held:
                    self._add_edge(h, lock, fi.path, line, (fi.qual,))
                    self._rank_check(findings, fi, h, lock, line, (fi.qual,))
            for cs in fi.calls:
                if not cs.held:
                    continue
                for t in cs.targets:
                    for lock in self.t_acq.get(t, ()):
                        chain = [fi.qual] + self._chain(t, lock, self.t_acq)
                        for h in cs.held:
                            self._add_edge(h, lock, fi.path, cs.line, chain)
                            self._rank_check(
                                findings, fi, h, lock, cs.line, chain
                            )

    def _rank_check(self, findings, fi, held, lock, line, chain) -> None:
        a = self.a
        rh, rl = a.rank(held), a.rank(lock)
        if rh is None or rl is None:
            return
        if held == lock and held in a.reentrant:
            return
        if rl <= rh:
            via = " -> ".join(chain)
            findings.append(
                Finding(
                    fi.path,
                    line,
                    "lock-order",
                    f"acquires {lock} (rank {rl}) while holding {held} "
                    f"(rank {rh}) via {via}",
                )
            )

    def _rule_lock_fsync(self, findings: list) -> None:
        hot = self.a.hot_locks
        for fi in self.a.functions.values():
            for kind, line, held in fi.blocking:
                for h in held:
                    if h in hot:
                        findings.append(
                            Finding(
                                fi.path,
                                line,
                                "lock-fsync",
                                f"blocking {kind} while holding {h} in "
                                f"{fi.qual}",
                            )
                        )
            for cs in fi.calls:
                if "lock-fsync" in cs.suppressed:
                    continue
                hl = [h for h in cs.held if h in hot]
                if not hl:
                    continue
                for t in cs.targets:
                    for kind in self.t_block.get(t, ()):
                        chain = [fi.qual] + self._chain(
                            t, kind, self.t_block
                        )
                        via = " -> ".join(chain)
                        for h in hl:
                            findings.append(
                                Finding(
                                    fi.path,
                                    cs.line,
                                    "lock-fsync",
                                    f"blocking {kind} reachable while "
                                    f"holding {h} via {via}",
                                )
                            )

    def _rule_wal_lease(self, findings: list) -> None:
        for fi in self.a.functions.values():
            if (
                fi.name.startswith("_")
                or fi.parent
                or not _in_dir(fi.scope, "core")
                or fi.cls == _WAL_CLASS
                or fi.lease_check
            ):
                continue
            w = self.u_wal.get(fi.qual)
            if w is None:
                continue
            chain = [fi.qual] + self._chain(fi.qual, None, self.u_wal)[1:]
            via = " -> ".join(chain)
            findings.append(
                Finding(
                    fi.path,
                    fi.lineno,
                    "wal-lease",
                    f"public entry {fi.qual} reaches a {w[2]} with no "
                    f"lease check on the path ({via})",
                )
            )

    def _rule_lock_cycle(self, findings: list) -> None:
        adj: dict = {}
        for (h, acq) in self.a.lock_edges:
            if h != acq:
                adj.setdefault(h, set()).add(acq)
        seen_cycles = set()
        WHITE, GREY, BLACK = 0, 1, 2
        colour: dict = {}

        def visit(node, path):
            colour[node] = GREY
            path.append(node)
            for nxt in sorted(adj.get(node, ())):
                c = colour.get(nxt, WHITE)
                if c == GREY:
                    loop = path[path.index(nxt):]
                    lo = loop.index(min(loop))
                    canon = tuple(loop[lo:] + loop[:lo])
                    if canon in seen_cycles:
                        continue
                    seen_cycles.add(canon)
                    src = self.a.lock_edges.get(
                        (node, nxt)
                    ) or ("?", 0, ())
                    findings.append(
                        Finding(
                            src[0],
                            src[1],
                            "lock-cycle",
                            "static lock-graph cycle: "
                            + " -> ".join(canon + (canon[0],)),
                        )
                    )
                elif c == WHITE and nxt in adj:
                    visit(nxt, path)
                else:
                    colour.setdefault(nxt, BLACK)
            path.pop()
            colour[node] = BLACK

        for node in sorted(adj):
            if colour.get(node, WHITE) == WHITE:
                visit(node, [])

    def _rule_registry_lock(self, findings: list) -> None:
        for fi in self.a.functions.values():
            lock = self.a.static_locks.get((fi.stem, "_lock"), "metrics._lock")
            for line, held in fi.registry_mut:
                if lock not in held:
                    findings.append(
                        Finding(
                            fi.path,
                            line,
                            "registry-lock",
                            f"registry mutation in {fi.qual} outside "
                            f"{lock}",
                        )
                    )


class _FactCollector:
    """Collects one function's direct facts + call sites, tracking the
    held-lock set through ``with`` regions."""

    def __init__(self, eng: _Engine, fi: FuncInfo):
        self.eng = eng
        self.a = eng.a
        self.fi = fi
        self.mod = eng.a.modules.get(fi.stem)
        self.env: dict = {}

    def run(self) -> None:
        self._build_env()
        body = getattr(self.fi.node, "body", [])
        self._walk_body(body, ())

    # -- local type environment -------------------------------------- #
    def _build_env(self) -> None:
        fi = self.fi
        env = self.env
        if fi.cls:
            env["self"] = {fi.cls}
            env["cls"] = {fi.cls}
        args = fi.node.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None:
                env[a.arg] = _ann_types(a.annotation)
        own = self._own_statements()
        for _ in range(3):
            for st in own:
                if isinstance(st, ast.Assign) and len(st.targets) == 1:
                    tgt = st.targets[0]
                    if isinstance(tgt, ast.Name):
                        t = self._infer(st.value)
                        if t:
                            env.setdefault(tgt.id, set()).update(t)
                elif isinstance(st, ast.AnnAssign) and isinstance(
                    st.target, ast.Name
                ):
                    env.setdefault(st.target.id, set()).update(
                        _ann_types(st.annotation)
                    )
                elif isinstance(st, (ast.For, ast.AsyncFor)) and isinstance(
                    st.target, ast.Name
                ):
                    elems = _elem_types(self._infer(st.iter))
                    if elems:
                        env.setdefault(st.target.id, set()).update(elems)

    def _own_statements(self) -> list:
        """Statements belonging to this function (not nested defs)."""
        out = []
        stack = list(getattr(self.fi.node, "body", []))
        while stack:
            st = stack.pop()
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            out.append(st)
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    stack.append(child)
                elif isinstance(child, (ast.excepthandler, ast.match_case)):
                    stack.extend(
                        c for c in ast.iter_child_nodes(child)
                        if isinstance(c, ast.stmt)
                    )
        return out

    def _infer(self, expr, depth: int = 0) -> set:
        if depth > 6 or expr is None:
            return set()
        if isinstance(expr, ast.Name):
            return set(self.env.get(expr.id, ()))
        if isinstance(expr, ast.Call):
            fn = expr.func
            if isinstance(fn, ast.Name):
                if fn.id == "cls":
                    return set(self.env.get("cls", ()))
                ci = self._local_class(fn.id)
                if ci is not None:
                    return {ci.name}
                target = self._name_func(fn.id)
                ti = self.a.functions.get(target) if target else None
                if ti is not None:
                    return {t for t in ti.returns}
            elif isinstance(fn, ast.Attribute):
                out = set()
                recv = self._infer(fn.value, depth + 1)
                if isinstance(fn.value, ast.Name):
                    owner = self._local_class(fn.value.id)
                    if owner is not None:
                        recv = recv | {owner.name}
                for t in recv:
                    if ":" in t:
                        continue
                    ci = self._local_class(t)
                    if ci is None:
                        continue
                    q = self.eng._resolve_method(ci, fn.attr)
                    ti = self.a.functions.get(q) if q else None
                    if ti is not None:
                        out |= ti.returns
                if out:
                    return out
                ci = self._local_class(fn.attr)
                if ci is not None:
                    return {ci.name}
            return set()
        if isinstance(expr, ast.Attribute):
            out = set()
            for t in self._infer(expr.value, depth + 1):
                ci = self._local_class(t)
                if ci is not None:
                    out |= ci.attr_types.get(expr.attr, set())
            return out
        if isinstance(expr, ast.Subscript):
            return _elem_types(self._infer(expr.value, depth + 1))
        if isinstance(expr, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
            saved = {}
            for gen in expr.generators:
                if isinstance(gen.target, ast.Name):
                    elems = _elem_types(self._infer(gen.iter, depth + 1))
                    saved[gen.target.id] = self.env.get(gen.target.id)
                    if elems:
                        self.env[gen.target.id] = elems
            elt = self._infer(expr.elt, depth + 1)
            for k, v in saved.items():
                if v is None:
                    self.env.pop(k, None)
                else:
                    self.env[k] = v
            return {f"list:{t}" for t in elt if ":" not in t}
        if isinstance(expr, ast.IfExp):
            return self._infer(expr.body, depth + 1) | self._infer(
                expr.orelse, depth + 1
            )
        if isinstance(expr, ast.BoolOp):
            out = set()
            for v in expr.values:
                out |= self._infer(v, depth + 1)
            return out
        if isinstance(expr, (ast.Await, ast.Starred)):
            return self._infer(expr.value, depth + 1)
        if isinstance(expr, (ast.List, ast.Tuple)):
            out = set()
            for elt in expr.elts:
                out |= self._infer(elt, depth + 1)
            return {f"list:{t}" for t in out if ":" not in t}
        return set()

    def _local_class(self, name: str):
        if self.mod is None:
            hits = self.a.classes_by_name.get(name, [])
            return hits[0] if len(hits) == 1 else None
        return self.eng._class_by_name(self.mod, name)

    def _name_func(self, name: str) -> str:
        fi = self.fi
        if name in fi.nested:
            return fi.nested[name]
        parent = self.a.functions.get(fi.parent)
        if parent is not None and name in parent.nested:
            return parent.nested[name]
        if self.mod is not None:
            if name in self.mod.functions:
                return self.mod.functions[name]
            if name in self.mod.from_names:
                stem, orig = self.mod.from_names[name]
                src = self.a.modules.get(stem)
                if src is not None and orig in src.functions:
                    return src.functions[orig]
        return ""

    # -- statement walk with held-lock tracking ------------------------ #
    def _walk_body(self, stmts, held) -> None:
        for st in stmts:
            self._walk_stmt(st, held)

    def _walk_stmt(self, st, held) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            inner = held
            for item in st.items:
                self._visit_expr(item.context_expr, inner)
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self.fi.acquires.append((inner, lock, st.lineno))
                    inner = inner + (lock,)
            self._walk_body(st.body, inner)
            return
        if isinstance(st, ast.Raise):
            exc = st.exc
            if isinstance(exc, ast.Call):
                exc = exc.func
            if isinstance(exc, ast.Name):
                self.fi.raises.add(exc.id)
            elif isinstance(exc, ast.Attribute):
                self.fi.raises.add(exc.attr)
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            self._check_registry_assign(st, held)
        for _name, value in ast.iter_fields(st):
            vals = value if isinstance(value, list) else [value]
            for v in vals:
                if isinstance(v, ast.stmt):
                    self._walk_stmt(v, held)
                elif isinstance(v, ast.expr):
                    self._visit_expr(v, held)
                elif isinstance(v, ast.excepthandler):
                    if v.type is not None:
                        self._visit_expr(v.type, held)
                    self._walk_body(v.body, held)
                elif isinstance(v, ast.match_case):
                    if v.guard is not None:
                        self._visit_expr(v.guard, held)
                    self._walk_body(v.body, held)

    def _visit_expr(self, expr, held) -> None:
        if expr is None:
            return
        for node in ast.walk(expr):
            if isinstance(node, ast.Call):
                self._handle_call(node, held)
            elif isinstance(node, ast.Attribute):
                if node.attr in _LEASE_ATTRS:
                    self.fi.lease_check = True
                if isinstance(node.ctx, ast.Load):
                    self._maybe_property_edge(node, held)

    def _suppressed(self, line: int) -> frozenset:
        if self.mod is None:
            return frozenset()
        return _suppressed_rules(self.mod.pragmas, line)

    def _lock_of(self, expr):
        attr = None
        if isinstance(expr, ast.Attribute) and _LOCKISH.search(expr.attr):
            attr = expr.attr
        elif isinstance(expr, ast.Name) and _LOCKISH.search(expr.id):
            attr = expr.id
        if attr is None:
            return None
        return self.a.static_locks.get(
            (self.fi.stem, attr), f"{self.fi.stem}.{attr}"
        )

    def _dotted(self, func) -> str:
        if isinstance(func, ast.Attribute) and isinstance(
            func.value, ast.Name
        ):
            base = func.value.id
            if self.mod is not None and base in self.mod.imports_ext:
                return f"{self.mod.imports_ext[base]}.{func.attr}"
            return f"{base}.{func.attr}"
        if isinstance(func, ast.Name):
            if self.mod is not None and func.id in self.mod.imports_ext:
                return self.mod.imports_ext[func.id]
            return func.id
        return ""

    def _handle_call(self, node: ast.Call, held) -> None:
        sup = self._suppressed(node.lineno)
        dotted = self._dotted(node.func)
        kind = _BLOCKING_CALLS.get(dotted)
        if kind is not None and "lock-fsync" not in sup:
            self.fi.blocking.append((kind, node.lineno, held))
        # reentrant-lock mints teach the analysis which names are RLocks
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "new_rlock"
            or isinstance(node.func, ast.Name)
            and node.func.id == "new_rlock"
        ):
            if node.args and isinstance(node.args[0], ast.Constant):
                if isinstance(node.args[0].value, str):
                    self.a.reentrant.add(node.args[0].value)
        targets, pending, skip_self = self._resolve_call(node)
        # thread / executor entry points: the callable argument is an edge
        extra = self._spawn_target(node)
        if extra:
            targets |= extra
            for q in extra:
                ti = self.a.functions.get(q)
                if ti is not None:
                    ti.thread_entry = True
        if targets or pending:
            self.fi.calls.append(
                CallSite(
                    node.lineno, held, targets, node, sup, pending, skip_self
                )
            )
        self._check_lease_call(targets)
        self._check_wal_recover(node, targets, sup)
        self._check_registry_call(node, held)

    def _spawn_target(self, node: ast.Call) -> set:
        fn = node.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else ""
        )
        out = set()
        if name == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    ref = self.eng._func_ref(self.fi, self.mod, kw.value)
                    if ref:
                        out.add(ref)
        elif name == "submit" and node.args:
            ref = self.eng._func_ref(self.fi, self.mod, node.args[0])
            if ref:
                out.add(ref)
        return out

    def _resolve_call(self, node: ast.Call):
        fn = node.func
        targets: set = set()
        pending = ""
        skip_self = True
        if isinstance(fn, ast.Name):
            skip_self = False
            q = self._name_func(fn.id)
            if q:
                targets.add(q)
            else:
                ci = self._local_class(fn.id)
                if ci is not None:
                    init = self.eng._resolve_method(ci, "__init__")
                    if init:
                        targets.add(init)
                        # ctor args align with __init__ params[1:]
                        skip_self = True
                elif fn.id in self.fi.params:
                    pending = fn.id
        elif isinstance(fn, ast.Attribute):
            m = fn.attr
            # module-alias call: wal.some_func(...)
            if isinstance(fn.value, ast.Name) and self.mod is not None:
                alias = self.mod.module_aliases.get(fn.value.id)
                src = self.a.modules.get(alias) if alias else None
                if src is not None:
                    if m in src.functions:
                        targets.add(src.functions[m])
                        return targets, pending, False
                    if m in src.classes:
                        init = self.eng._resolve_method(
                            src.classes[m], "__init__"
                        )
                        if init:
                            targets.add(init)
                    # ctor args align with __init__ params[1:]
                    return targets, pending, True
            recv = self._infer(fn.value)
            classes = {t for t in recv if ":" not in t}
            # ClassName.method(...) — unbound call through the class object
            if isinstance(fn.value, ast.Name):
                ci = self._local_class(fn.value.id)
                if ci is not None:
                    classes.add(ci.name)
                    skip_self = False
            if "self" == getattr(fn.value, "id", None) or "cls" == getattr(
                fn.value, "id", None
            ):
                # borrowed-method receivers: DSLog code may run with a
                # ShardedDSLog self when Sharded aliases DSLog methods
                classes |= self.eng._borrowers.get(self.fi.cls, set())
            resolved = set()
            for cname in set(classes):
                for sub in {cname} | self.eng._subclasses(cname):
                    ci = self._local_class(sub)
                    if ci is not None:
                        q = self.eng._resolve_method(ci, m)
                        if q:
                            resolved.add(q)
            if not resolved and not classes:
                resolved |= self._fallback_by_name(m)
            if (
                not resolved
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "self"
                and self.fi.cls
            ):
                # instance-attribute callback: self._loader() dispatches
                # to the functions construction sites bound to the param
                owner = self._local_class(self.fi.cls)
                cb = (
                    owner.callback_attrs.get(m) if owner is not None
                    else None
                )
                if cb is not None:
                    pending = f"{cb[0]}::{cb[1]}"
            targets |= resolved
        return targets, pending, skip_self

    def _fallback_by_name(self, m: str) -> set:
        if m in _GENERIC_METHODS or m.startswith("__"):
            return set()
        owners = []
        for infos in self.a.classes_by_name.values():
            for ci in infos:
                if m in ci.methods:
                    owners.append(ci.methods[m])
        return set(owners) if len(owners) == 1 else set()

    def _maybe_property_edge(self, node: ast.Attribute, held) -> None:
        recv = self._infer(node.value)
        for t in recv:
            if ":" in t:
                continue
            ci = self._local_class(t)
            if ci is not None and node.attr in ci.properties:
                self.fi.calls.append(
                    CallSite(
                        node.lineno,
                        held,
                        {ci.methods[node.attr]},
                        ast.Call(
                            func=node, args=[], keywords=[],
                        ),
                        self._suppressed(node.lineno),
                    )
                )

    def _check_lease_call(self, targets: set) -> None:
        for q in targets:
            ti = self.a.functions.get(q)
            if ti is None:
                continue
            if ti.name == "_ensure_shard_lease" or (
                ti.cls == _LEASE_CLASS and ti.name in ("acquire", "held")
            ):
                self.fi.lease_check = True

    def _check_wal_recover(self, node: ast.Call, targets, sup) -> None:
        if "wal-lease" in sup:
            return
        for q in targets:
            ti = self.a.functions.get(q)
            if ti is None or ti.cls != _WAL_CLASS or ti.name != "recover":
                continue
            for kw in node.keywords:
                if (
                    kw.arg == "truncate"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                ):
                    self.fi.wal_direct.append(("wal-truncate", node.lineno))

    def _is_registry_attr(self, expr) -> bool:
        # __init__ mutates freely: the registry is not yet published to
        # any other thread while its constructor runs
        return (
            self.fi.cls == _REGISTRY_CLASS
            and self.fi.name != "__init__"
            and isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and expr.attr in _REGISTRY_ATTRS
        )

    def _check_registry_assign(self, st, held) -> None:
        targets = (
            st.targets if isinstance(st, ast.Assign) else [st.target]
        )
        for tgt in targets:
            probe = tgt.value if isinstance(tgt, ast.Subscript) else tgt
            if self._is_registry_attr(probe):
                if "registry-lock" not in self._suppressed(st.lineno):
                    self.fi.registry_mut.append((st.lineno, held))

    def _check_registry_call(self, node: ast.Call, held) -> None:
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _DICT_MUTATORS
            and self._is_registry_attr(node.func.value)
        ):
            if "registry-lock" not in self._suppressed(node.lineno):
                self.fi.registry_mut.append((node.lineno, held))


# -------------------------------------------------------------------------- #
# public API
# -------------------------------------------------------------------------- #


def analyze_paths(
    paths,
    lock_order=None,
    static_locks=None,
    reentrant=None,
    hot_locks=None,
) -> Analysis:
    """Run the full analysis over ``paths`` (files or directories).

    The lock tables default to :mod:`repro_torch.tools.lockorder`; tests inject
    fixture tables.  ``hot_locks`` defaults to every ranked lock except
    ``commit._flush_mutex`` — the group-commit barrier exists precisely to
    be held across the WAL flush, so blocking I/O under it is its job, not
    a finding."""
    lo = dict(LOCK_ORDER if lock_order is None else lock_order)
    sl = dict(STATIC_LOCKS if static_locks is None else static_locks)
    hot = (
        set(lo) - {"commit._flush_mutex"} if hot_locks is None else
        set(hot_locks)
    )
    analysis = Analysis(lo, sl, set(reentrant or ()), hot)
    eng = _Engine(analysis)
    t0 = time.perf_counter()
    files = [
        p for p in iter_py_files(paths)
        if os.path.basename(p) != "__init__.py" or os.path.getsize(p) > 0
    ]
    for path in files:
        try:
            eng.index_module(path)
        except (SyntaxError, OSError) as exc:
            analysis.findings.append(
                Finding(path, 0, "parse", str(exc))
            )
    t1 = time.perf_counter()
    eng.link_classes()
    eng.collect_all()
    t2 = time.perf_counter()
    eng.bind_params()
    eng.propagate()
    t3 = time.perf_counter()
    eng.report()
    t4 = time.perf_counter()
    analysis.stats = {
        "files": len(files),
        "functions": len(analysis.functions),
        "lock_edges": len(analysis.lock_edges),
        "parse_s": round(t1 - t0, 4),
        "collect_s": round(t2 - t1, 4),
        "fixpoint_s": round(t3 - t2, 4),
        "rules_s": round(t4 - t3, 4),
    }
    return analysis


def _baseline_key(f: Finding) -> tuple:
    return (f.rule, _scope_key(f.path), f.message)


def load_baseline(path: str) -> set:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    out = set()
    for rec in data.get("findings", []):
        out.add((rec["rule"], rec["path"], rec["message"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.dsflow",
        description="interprocedural lock/effect analysis for the DSLog "
        "core",
    )
    ap.add_argument("paths", nargs="*", help="files or directories")
    ap.add_argument("--json", action="store_true", help="machine-readable")
    ap.add_argument("--baseline", help="known-findings file; fail only on "
                    "new findings")
    ap.add_argument("--write-baseline", help="record current findings")
    ap.add_argument("--check-dynamic", help="racecheck edge export to "
                    "cross-check against the static graph")
    ap.add_argument("--stats", action="store_true", help="phase timings to "
                    "stderr")
    args = ap.parse_args(argv)
    if not args.paths:
        ap.error("no paths given")
    analysis = analyze_paths(args.paths)
    if args.check_dynamic:
        try:
            with open(args.check_dynamic, encoding="utf-8") as fh:
                dyn = json.load(fh)
        except (OSError, ValueError) as exc:
            print(f"dsflow: cannot read {args.check_dynamic}: {exc}",
                  file=sys.stderr)
            return 2
        analysis.findings.extend(
            analysis.check_dynamic(dyn.get("edges", []))
        )
    findings = analysis.findings
    if args.write_baseline:
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(
                {
                    "findings": [
                        {
                            "rule": f.rule,
                            "path": _scope_key(f.path),
                            "message": f.message,
                        }
                        for f in findings
                    ]
                },
                fh,
                indent=2,
            )
            fh.write("\n")
    if args.baseline:
        try:
            known = load_baseline(args.baseline)
        except (OSError, ValueError, KeyError) as exc:
            print(f"dsflow: cannot read baseline: {exc}", file=sys.stderr)
            return 2
        findings = [f for f in findings if _baseline_key(f) not in known]
    if args.stats:
        print(f"dsflow stats: {analysis.stats}", file=sys.stderr)
    if args.json:
        report = analysis.to_json()
        report["findings"] = [f.to_dict() for f in findings]
        print(json.dumps(report, indent=2))
    else:
        for f in findings:
            print(f)
        print(f"dsflow: {len(findings)} finding(s), "
              f"{len(analysis.lock_edges)} lock edge(s), "
              f"{len(analysis.functions)} function(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
