"""Production mesh construction (the port of ``repro.launch.mesh``).

Functions, not module-level constants: importing this module touches no
process group.  A live mesh (``device`` "cuda" or "cpu") must be built on
every rank of an initialised group (``dist.meshctx.spawn_ranks``,
``init_from_env`` or ``torchrun``) with at least as many ranks as the mesh
has; ``make_mesh`` raises otherwise.  ``device="meta"`` needs no group:
it returns a mesh on the meta device (world rank ``rank``'s, for
:func:`make_production_mesh`; rank 0's otherwise), whose axes hold
``meshctx.MetaGroup``s (the dry run of the 256- and 512-rank meshes,
``launch/dryrun.py``).
"""

from __future__ import annotations

from repro_torch.dist import meshctx


def _make(shape, axes, device, backend, rank: int = 0):
    if str(device) == "meta":
        return meshctx.make_meta_mesh(shape, axes, rank)
    return meshctx.make_mesh(shape, axes, device=device, backend=backend)


def make_production_mesh(*, multi_pod: bool = False, device="cuda", backend=None,
                         rank: int = 0):
    """(16, 16) single-pod (256 ranks) or (2, 16, 16) multi-pod (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make(shape, axes, device, backend, rank)


def make_mesh_for(devices: int, tp: int = 16, pods: int = 1, *, device="cuda",
                  backend=None):
    """The mesh for an arbitrary surviving-device count (``dist.elastic``
    plans it): ``devices / (tp * pods)`` data ranks of ``tp`` model ranks."""
    if devices % (tp * pods):
        raise ValueError(f"{devices} devices do not split into {pods} pod(s) of "
                         f"tp={tp}")
    data = devices // (tp * pods)
    if pods > 1:
        return _make((pods, data, tp), ("pod", "data", "model"), device, backend)
    return _make((data, tp), ("data", "model"), device, backend)
