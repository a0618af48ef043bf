"""Activation sharding hints (the port of ``repro.distributed.sharding``'s
``hint``).

The model code calls ``hint(x, kind)`` at the same layout decision points
as the reference.  The reference's hints are no-ops until a launcher
activates a mesh; the port runs on one card with no mesh, so ``hint`` is
the identity.  Meshes, ``param_sharding`` and the logical specs wait for
the distributed slice of the port.
"""

from __future__ import annotations

__all__ = ["hint"]


def hint(x, kind: str):
    """Return ``x`` unchanged: one card, no mesh (the reference's ``hint``
    without an activated mesh)."""
    return x
