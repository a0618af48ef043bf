"""The shared finding schema every analysis tool's ``--json`` mode emits.

A copy of ``repro.tools.findings``.  One flat record shape —
``{tool, rule, severity, path, line, message}`` — so the health report
(``repro_torch.obs.export.health``) and CI's artifact consumers parse a
single format regardless of which layer produced the finding:

* ``tool``      — producing tool name (``dslint``, ``dsflow``, ``fsck``)
* ``rule``      — the rule / check category within that tool
* ``severity``  — ``error`` | ``warn`` | ``info``
* ``path``      — file (or store-relative object) the finding is about
* ``line``      — 1-based source line, or 0 when lines don't apply
  (on-disk store objects, whole-file findings)
* ``message``   — human-readable detail
"""

from __future__ import annotations

SCHEMA_KEYS = ("tool", "rule", "severity", "path", "line", "message")
SEVERITIES = ("error", "warn", "info")


def finding_dict(
    tool: str, rule: str, severity: str, path: str, line: int, message: str
) -> dict:
    """A schema-shaped finding record (validated)."""
    rec = {
        "tool": tool,
        "rule": rule,
        "severity": severity,
        "path": path,
        "line": line,
        "message": message,
    }
    validate_finding(rec)
    return rec


def validate_finding(rec: object) -> None:
    """Raise ``ValueError`` unless ``rec`` is a valid shared-schema record."""
    if not isinstance(rec, dict):
        raise ValueError(f"finding must be a dict, got {type(rec).__name__}")
    missing = [k for k in SCHEMA_KEYS if k not in rec]
    if missing:
        raise ValueError(f"finding missing keys {missing}: {rec!r}")
    for key in ("tool", "rule", "severity", "path", "message"):
        if not isinstance(rec[key], str):
            raise ValueError(f"finding[{key!r}] must be a string: {rec!r}")
    if not isinstance(rec["line"], int) or isinstance(rec["line"], bool):
        raise ValueError(f"finding['line'] must be an int: {rec!r}")
    if rec["line"] < 0:
        raise ValueError(f"finding['line'] must be >= 0: {rec!r}")
    if rec["severity"] not in SEVERITIES:
        raise ValueError(
            f"finding['severity'] must be one of {SEVERITIES}: {rec!r}"
        )


def validate_findings(recs: object) -> int:
    """Validate a list of records; returns the count."""
    if not isinstance(recs, list):
        raise ValueError(f"findings must be a list, got {type(recs).__name__}")
    for rec in recs:
        validate_finding(rec)
    return len(recs)
