"""Distribution layer of the port (``repro.distributed``): logical-axis
sharding rules resolved against a ``DeviceMesh`` (``sharding``), explicit collectives over a process group, the
differentiable ones of the mesh's training step among them
(``collectives``), and ``reshard_tree`` and the straggler watchdog
(``elastic``).  Meshes are made in ``launch.mesh``; ``launch.train``
trains on a ``("data", "model")`` mesh over a group."""

from .collectives import (  # noqa: F401
    flash_decode_combine,
    local_partial_attention,
    pipeline_stage_step,
)
from .elastic import StepWatchdog, reshard_tree  # noqa: F401
from .sharding import (  # noqa: F401
    AxisRules,
    batch_sharding,
    cache_sharding,
    default_rules,
    hint,
    logical_to_spec,
    param_sharding,
)
