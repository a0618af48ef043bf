"""Store tools of the port, copies of ``repro.tools``'s with the port's names.

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
