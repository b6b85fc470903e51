"""repro_torch.dist — the single-device part of ``repro.dist``: the
compressed-gradient emulation of the data-parallel all-reduce
(``launch.train --compress-grads``).  The ring all-reduce, the mesh and
the fleet are not ported yet (one device)."""
