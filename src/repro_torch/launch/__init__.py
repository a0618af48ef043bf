"""Launchers of the port: ``serve`` (batched greedy decoding), ``train``
(the trainer, data-parallel over an initialised process group), ``steps``
(the step functions both share) and ``mesh`` (``DeviceMesh``es over a
group's ranks).  The dry run waits for the port's own design."""
