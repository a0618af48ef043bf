"""Launchers of the port: ``serve`` (batched greedy decoding), ``train``
(the trainer) and ``steps`` (the step functions both share).  Meshes and
the dry run wait for the port's distributed slice."""
