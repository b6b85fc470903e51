"""repro_torch.dist — the port of ``repro.dist``: the mesh over
``torch.distributed`` and the rank spawner (``meshctx``), the name-rule
partition specs and the slicing of trees to a rank's shards
(``sharding``), the compressed-gradient emulation, the int8 ring
all-reduce and the exact collectives of tensor parallelism
(``collectives``), elastic rescale planning (``elastic``) and the replica
fleet (``fleet``: one ``(1, tp)`` mesh a replica over slices of the
ranks; in a world of one rank every replica on the one device).  The HLO
analysis has no torch counterpart yet (ROADMAP §A)."""
