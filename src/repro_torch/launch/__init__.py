"""Launchers of the port: ``serve`` (batched greedy decoding).  Training,
meshes and the dry run wait for later slices of the port."""
