"""Distribution helpers of the port: ``sharding.hint`` and
``elastic.StepWatchdog`` so far.  The meshes, parameter shardings,
collectives and ``reshard_tree`` of ``repro.distributed`` come with the
port's distributed slice."""

from .elastic import StepWatchdog  # noqa: F401
from .sharding import hint  # noqa: F401
