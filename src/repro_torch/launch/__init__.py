"""Launchers of the port: ``serve`` (batched greedy decoding), ``train``
(the trainer, on a ``("data", "model")`` mesh over an initialised process
group: ZeRO-3 and tensor parallelism), ``steps`` (the step functions both
share) and ``mesh`` (``DeviceMesh``es over a group's ranks).  The dry run
waits for the port's own design."""
