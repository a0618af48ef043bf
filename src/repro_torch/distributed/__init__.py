"""Distribution helpers of the port.  Only ``sharding.hint`` so far: the
meshes, parameter shardings and collectives of ``repro.distributed`` come
with the port's distributed slice."""

from .sharding import hint  # noqa: F401
