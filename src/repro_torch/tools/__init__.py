"""Store and analysis tools of the port, copies of ``repro.tools``'s with
the port's names.

* :mod:`repro_torch.tools.dslint` — AST lint pass enforcing project
  invariants (context-managed locks, the declared lock order, atomic
  manifest writes, fsynced blob writes, no bare ``except:`` / mutable
  default args / unguarded int32 casts in kernel packers).
  Run as ``python -m repro_torch.tools.dslint src/repro_torch``.
* :mod:`repro_torch.tools.dsflow` — interprocedural lock/effect analysis
  (transitive lock order, blocking I/O under a lock, WAL appends without
  a lease check, lock cycles), with ``--check-dynamic`` against the race
  detector's exported acquisition graph.
  Run as ``python -m repro_torch.tools.dsflow src/repro_torch``.
  Both parse each file once through :mod:`repro_torch.tools.astcache`.
* :mod:`repro_torch.tools.racecheck` — opt-in dynamic lock-order / race
  detector.  Set ``DSLOG_RACE_DETECT=1`` and ``repro_torch.core._locks``
  hands out instrumented locks that record the per-thread acquisition graph
  plus unguarded mutations of registered shared state (``io_stats``,
  ``hop_stats``, shard caches).
* :mod:`repro_torch.tools.fsck` — deep, non-mutating on-disk verifier; it
  reads files only and needs no device.
  Run as ``python -m repro_torch.tools.fsck <store>``.
* :mod:`repro_torch.tools.mkstore` — builds a small sharded store
  (``python -m repro_torch.tools.mkstore ROOT --device cpu``).
* :mod:`repro_torch.tools.dstat` — the ``telemetry.json`` inspector.

The declared lock-order table shared with the reference's static lint lives
in :mod:`repro_torch.tools.lockorder`; it stays rank for rank equal to
``repro.tools.lockorder``'s, which the lint resolves the port's locks
against by (module stem, attribute).
"""
