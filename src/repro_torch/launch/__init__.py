"""Launch layer of the port: the fleet's device and host views
(``mesh.FleetMeshView``, ``distributed``'s host types), ``shard_bounds``
and the serving CLI (``python -m repro_torch.launch.serve``)."""
