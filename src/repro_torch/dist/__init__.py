"""repro_torch.dist — the one-device part of ``repro.dist``: the
compressed-gradient emulation of the data-parallel all-reduce
(``launch.train --compress-grads``), elastic rescale planning
(``elastic``) and the replica fleet (``fleet``: every replica on one
device).  The ring all-reduce, the mesh and tensor parallelism are not
ported yet."""
