"""Shared single-parse AST cache for the static-analysis tools (the
port's copy of ``repro.tools.astcache``).

``dslint`` and ``dsflow`` both walk every file under ``src/``; parsing is
the dominant cost of a lint run and each tool used to re-read and re-parse
independently.  This module parses each file exactly once per content
version — entries are keyed by ``(st_mtime_ns, st_size)`` so an edited
file re-parses and an unchanged file never does — and additionally
precomputes a node index (``type → [nodes]``) so rules iterate only the
node types they care about instead of re-walking the whole tree per rule.
"""

from __future__ import annotations

import ast
import os


class ParsedFile:
    """One parsed source file plus a lazily built per-type node index."""

    __slots__ = ("path", "source", "tree", "_nodes", "_by_type")

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self._nodes: list[ast.AST] | None = None
        self._by_type: dict[type, list[ast.AST]] | None = None

    @property
    def nodes(self) -> list[ast.AST]:
        """Every node in the tree, walked exactly once and memoised."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def by_type(self, *types: type) -> list[ast.AST]:
        """All nodes whose exact class is one of ``types`` (no subclassing:
        the index is keyed on ``type(node)``, which is what ``ast`` rules
        match in practice)."""
        if self._by_type is None:
            index: dict[type, list[ast.AST]] = {}
            for node in self.nodes:
                index.setdefault(type(node), []).append(node)
            self._by_type = index
        out: list[ast.AST] = []
        for t in types:
            out.extend(self._by_type.get(t, ()))
        return out


# path → (stat key, ParsedFile)
_CACHE: dict[str, tuple[tuple[int, int], ParsedFile]] = {}


def parse(path: str) -> ParsedFile:
    """Parse ``path`` (or return the cached parse if unchanged on disk).

    Raises ``SyntaxError`` / ``OSError`` like ``ast.parse`` / ``open``;
    failures are never cached.
    """
    st = os.stat(path)
    key = (st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path, encoding="utf-8") as f:
        source = f.read()
    parsed = ParsedFile(path, source, ast.parse(source, filename=path))
    _CACHE[path] = (key, parsed)
    return parsed


def clear() -> None:
    """Drop the cache (tests; long-lived tool processes)."""
    _CACHE.clear()
