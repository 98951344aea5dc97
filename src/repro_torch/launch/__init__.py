"""Launch layer of the port: the fleet's device and host views
(``mesh.FleetMeshView``, ``distributed``'s host types), ``shard_bounds``,
the serving CLI (``python -m repro_torch.launch.serve``), and the SPMD
layer: logical-axis rules (``sharding``), partition specs
(``partition``), the tensor-parallel runtime (``spmd``, ``tp_serve``)
and the dry run's meshes and hillclimb (``dryrun``, ``variants``,
``hillclimb``)."""
