"""Tensor-parallel serving: the serve core on a mesh of ranks (the port of
``repro.serve.sharded``, DESIGN.md §14).

The reference hands its engine to GSPMD: one program, parameters and
decode state partitioned over a ``jax.sharding.Mesh``.  The port runs one
process a rank (``dist/meshctx.py``): every rank builds the same
:class:`ShardedServeCore`, holds its shards of the parameters
(``dist/sharding.py``; the packs built on each shard) and its heads of the
KV cache, and runs the same :class:`~repro_torch.serve.engine.ServeCore`
host logic (SPMD).  The model's explicit collectives keep the ranks in step
inside a tick: the embedding's all-reduce, two all-reduces a layer (the
row-parallel partials; a Mamba-2 layer's ``gnorm`` sum of squares and
``out_proj``), the kv heads' all-gathers of an MQA attention block that tp
does not divide, and the all-gather of the logits before sampling, so
every rank samples the same tokens from the same rows.  Every family with a
decode step serves: the recurrent families on their state caches, cut to
the rank's heads and channels (``dist/sharding.py``), with bucketed,
packed admission as on one device.

Host decisions must be identical on every rank, or the ranks diverge and
a collective hangs or mixes two steps.  Everything the core decides from
its inputs is (slot admission, QoS rungs from occupancy, seeded fault
draws, greedy or seeded sampling on identical logits, guard bits and the
quality tap on gathered logits); the one per-process source is the clock,
so a sharded core reads rank 0's clock, broadcast (:class:`SharedClock`),
unless a deterministic one (``resil.VirtualClock``) is passed.  At drain
the ranks' token streams are all-gathered and must be equal.

Two collective regimes on the decode path, as in the reference:

  * ``ring=False`` — exact f32 all-reduces of the row-parallel partials:
    sharded decode equals the same parameters served on one device, up to
    the order of the f32 sums;
  * ``ring=True`` — under EXACT the row-parallel reductions go through the
    int8 ring (``kernels/ops.py`` ``ring_tp``, opened around each tick):
    about a quarter of the bytes at a small reduction error.

The sharded step runs eagerly.  A gloo collective cannot be captured in a
CUDA graph, so ``capture=True`` under a gloo group raises; capture under
NCCL needs one card a rank, and a mesh with a data axis above 1 (replicas
of the sharded engine) is not served yet: both raise (ROADMAP §A).

:func:`lm_decode_collective_bytes` runs one decode step on the active
mesh and returns its collective bytes by kind from the collectives' byte
counters — the reference's probe of one compiled ``decode_step``, whose
logits stay sharded over ``model``; the engine's all-gather of the logits
for sampling is outside it, as it is outside the reference's.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch.distributed as dist

from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import check_tp_supported
from repro_torch.serve.engine import ServeCore
from repro_torch.serve.lm import LMAdapter, Request


class SharedClock:
    """Rank 0's clock on every rank of the mesh's ``model`` group: each
    call is a broadcast, made at the same point of the program on every
    rank (the host logic is SPMD)."""

    def __init__(self, mesh: meshctx.Mesh, base=time.time):
        self.mesh = mesh
        self.base = base

    def __call__(self) -> float:
        m = self.mesh
        t = self.base() if m.coord("model") == 0 else 0.0
        return collectives.broadcast_value(t, m.group("model"), m.device)


class ShardedServeCore(ServeCore):
    """:class:`~repro_torch.serve.engine.ServeCore` on ``mesh`` (default:
    the active mesh): ``params`` is the global float tree, cut here to this
    rank's shards and then packed on the shards; every construction step
    and tick runs under the mesh and, with ``ring=True``, the int8-ring
    lever (no-op on a 1-wide model axis).  Everything else is the generic
    core."""

    def __init__(self, workload, params, *, mesh: Optional[meshctx.Mesh] = None,
                 ring: bool = False, capture: Optional[bool] = None, clock=None, **kw):
        self.mesh = mesh if mesh is not None else meshctx.get_mesh()
        tp = self.mesh.size("model")
        wide = {a: self.mesh.size(a) for a in meshctx.batch_axes(self.mesh)
                if self.mesh.size(a) > 1}
        if wide:
            raise NotImplementedError(
                f"a serving data axis above 1 ({wide}): replicas of the sharded engine "
                "and the slot batch over the data axes are ROADMAP §A")
        if capture and tp > 1:
            if self.mesh.backend == "gloo":
                raise ValueError(
                    "capture=True under a gloo group: a gloo collective cannot be captured "
                    "in a CUDA graph; the sharded step runs eagerly (capture=None)")
            raise NotImplementedError(
                "capture of the sharded step under NCCL (one card a rank) is ROADMAP §A")
        check_tp_supported(workload.cfg, tp)
        if getattr(workload, "tp", tp) != tp:
            raise ValueError(f"the workload's tp={workload.tp} is not the mesh's model "
                             f"axis ({tp})")
        self.ring = bool(ring) and tp > 1
        if clock is None and tp > 1:
            clock = SharedClock(self.mesh)
        with self._mesh_ctx():
            if tp > 1:
                params = sharding.shard_params(params, mesh=self.mesh)
            super().__init__(workload, params, capture=False if tp > 1 else capture,
                             clock=clock, **kw)

    def _mesh_ctx(self):
        """The engine's mesh and, with ``ring``, the ring lever."""
        ctx = contextlib.ExitStack()
        ctx.enter_context(meshctx.use_mesh(self.mesh))
        if self.ring:
            ctx.enter_context(kops.ring_tp())
        return ctx

    def tick(self) -> int:
        with self._mesh_ctx():
            return super().tick()

    def streams(self) -> list:
        """(rid, status, tokens) of every finished request, by rid."""
        return [(r.rid, r.status, tuple(r.out)) for r in sorted(self.done, key=lambda r: r.rid)]

    def check_streams(self) -> None:
        """All-gather the ranks' streams; raises unless they are equal."""
        g = self.mesh.group("model")
        if g is None:
            return
        mine = self.streams()
        got = [None] * dist.get_world_size(g)
        dist.all_gather_object(got, mine, group=g)
        bad = [r for r, s in enumerate(got) if s != mine]
        if bad:
            raise RuntimeError(f"the ranks' token streams diverged (group ranks {bad} differ "
                               f"from rank {dist.get_rank(g)})")

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        """:meth:`ServeCore.run_until_drained`, then :meth:`check_streams`."""
        done = super().run_until_drained(max_ticks)
        self.check_streams()
        return done


class ShardedServeEngine(ShardedServeCore):
    """The LM facade over the sharded core: ``ServeEngine``'s construction
    surface plus ``mesh=`` / ``ring=``.  ``tp`` defaults to the mesh's
    model axis; ``params`` come from ``model.init(tp=<model axis>)``, so
    the padded heads, vocab and experts divide the axis."""

    def __init__(self, model, params, *, mesh: Optional[meshctx.Mesh] = None,
                 ring: bool = False, slots: int = 8, max_len: int = 512,
                 eos_id: int = -1, tp: Optional[int] = None, greedy: bool = True,
                 temperature: float = 1.0, top_k: int = 0, admission=None, **kw):
        mesh = mesh if mesh is not None else meshctx.get_mesh()
        tp = mesh.size("model") if tp is None else tp
        workload = LMAdapter(model, tp=tp, eos_id=eos_id, greedy=greedy,
                             temperature=temperature, top_k=top_k, max_len=max_len,
                             admission=admission)
        super().__init__(workload, params, mesh=mesh, ring=ring, slots=slots,
                         max_len=max_len, **kw)
        self.model = model
        self.tp = tp
        self.eos_id = eos_id

    @property
    def cache(self):
        return self.state

    def submit(self, prompt, max_new_tokens: int = 32, **kw) -> Request:
        return super().submit(prompt, max_new_tokens, **kw)


def lm_decode_collective_bytes(arch: str = "tinyllama-1.1b-smoke", *, batch: int = 2,
                               max_len: int = 32, ring: bool = False, policy=None) -> dict:
    """The collective bytes of one sharded decode step of ``arch`` (any
    family with a decode step: its cache is the rank's) on the active
    mesh's ``model`` axis, by kind (``all-reduce``, ``all-gather``,
    ``collective-permute`` for the ring's hops) plus ``"total"``, from
    :data:`repro_torch.dist.collectives.counter`.  Every rank of the group
    calls it; the weights are the arch's seeded init, padded for the axis."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    mesh = meshctx.get_mesh()
    tp = mesh.size("model")
    model = build_model(get_config(arch), policy, device=mesh.device)
    params = model.prepack(sharding.shard_params(model.init(seed=0, tp=tp), mesh=mesh))
    cache = model.init_cache(tp=tp, batch=batch, max_len=max_len)
    tokens = cache.length.new_zeros((batch, 1)).long()
    collectives.counter.reset()
    with kops.ring_tp(ring and tp > 1):
        model.decode_step(params, cache, tokens, tp=tp)
    snap = collectives.counter.snapshot()
    return {**snap["bytes"], "total": snap["total"]}
