"""Launchers of the port: ``serve`` (batched greedy decoding), ``train``
(the trainer, on a ``("data", "model")`` mesh over an initialised process
group: ZeRO-3 and tensor parallelism), ``steps`` (the step functions they
share, placed prefill and decode, and the abstract states), ``mesh``
(``DeviceMesh``es over a group's ranks) and ``dryrun`` (the steps run as
rank 0 of a fake process group on fake tensors)."""
