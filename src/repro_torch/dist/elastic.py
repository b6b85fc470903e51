"""Elastic rescale planning (the port of ``repro.dist.elastic``, pure
arithmetic).

When preemption or hardware failure shrinks the device pool, the trainer
restarts from a mesh-agnostic checkpoint onto whatever survives.  This
module maps a surviving device count to a coherent (pod, data, model) mesh
and a gradient-accumulation factor that preserves the *effective* global
batch:

  * tensor parallelism is kept at the requested ``tp`` while it fits, and
    degraded by powers of two when fewer devices than ``tp`` survive;
  * the per-data-replica microbatch is held at its full-pod value
    (``target_global_batch / (devices_per_pod / tp)``), so activation
    memory per device never grows on the shrunken mesh;
  * lost data parallelism is bought back with ``grad_accum`` microsteps;
  * ragged survivor counts (7 of 8 devices) never crash the recovery path:
    the data axis degrades to the largest power-of-two subset that
    factors, and the devices left over are reported as ``idle_devices``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RescalePlan:
    n_devices: int
    pods: int
    data: int              # data-parallel degree per pod
    model: int             # tensor-parallel degree
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    per_step_batch: int    # sequences per optimizer microstep (all pods)
    grad_accum: int
    effective_batch: int   # per_step_batch * grad_accum (>= target)
    idle_devices: int = 0  # survivors the mesh cannot use (ragged counts)


def plan_rescale(devices: int, *, target_global_batch: int, tp: int,
                 devices_per_pod: int = 256) -> RescalePlan:
    """Plan the mesh and accumulation for ``devices`` surviving devices."""
    if devices <= 0:
        raise ValueError("no surviving devices")
    pods = max(devices // devices_per_pod, 1)
    per_pod = devices // pods

    model = tp
    while model > 1 and model > per_pod:
        model //= 2
    if per_pod % model == 0:
        # exact factorization: every survivor serves
        data = per_pod // model
    else:
        # ragged count: the largest power-of-two data axis that fits; the
        # surplus idles (power-of-two replica groups keep routing uniform)
        data = 1
        while data * 2 * model <= per_pod:
            data *= 2
    idle = devices - pods * data * model

    if pods > 1:
        mesh_shape: tuple[int, ...] = (pods, data, model)
        mesh_axes: tuple[str, ...] = ("pod", "data", "model")
    else:
        mesh_shape = (data, model)
        mesh_axes = ("data", "model")

    # full-pod microbatch per data replica (activations never grow)
    data_full = max(devices_per_pod // tp, 1)
    replica_batch = max(target_global_batch // data_full, 1)
    per_step = replica_batch * data * pods
    grad_accum = max(-(-target_global_batch // per_step), 1)
    return RescalePlan(n_devices=devices, pods=pods, data=data, model=model,
                       mesh_shape=mesh_shape, mesh_axes=mesh_axes,
                       per_step_batch=per_step, grad_accum=grad_accum,
                       effective_batch=per_step * grad_accum, idle_devices=idle)
