"""Sharded serving: the serve core on a mesh of ranks (the port of
``repro.serve.sharded``, DESIGN.md §14).

The reference hands its engine to GSPMD: one program, parameters and
decode state partitioned over a ``jax.sharding.Mesh``.  The port runs one
process a rank (``dist/meshctx.py``): every rank builds the same
:class:`ShardedServeCore`, holds its shards of the parameters
(``dist/sharding.py``; the packs built on each shard) and its part of the
cache, and runs the same :class:`~repro_torch.serve.engine.ServeCore`
host logic (SPMD).

The ``model`` axis splits the weights and the heads.  The model's explicit
collectives keep a model group's ranks in step inside a tick: the
embedding's all-reduce, two all-reduces a layer (the row-parallel
partials; a Mamba-2 layer's ``gnorm`` sum of squares and ``out_proj``),
the kv heads' all-gathers of an MQA attention block that tp does not
divide, and the all-gather of the logits before sampling.  Every family
with a decode step serves: the recurrent families on their state caches,
cut to the rank's heads and channels, with bucketed, packed admission as
on one device.

The data axes split the slots (:class:`SlotShard`): on a ``(D, M)`` mesh
data coordinate ``d`` holds slots ``[d S/D, (d + 1) S/D)`` of the ``S``
(``slots`` must divide by ``D``), its cache cut as
``sharding.shard_cache``'s specs cut it (batch over ``data``, heads over
``model``), and its model group runs every device call on those rows only
(:class:`ShardedLMAdapter`): a packed admission call keeps this rank's
rows (the others become dummy rows that write nothing, and a call with
none of its rows is skipped), a chunk call and a slot reset run on the
slot's owner, a seeded ``seu_state`` flip lands on the flipped slot's
owner, a parameter flip on every rank that holds the element.  The tick's
one read gathers the emission of all ``S`` slots over ``data`` — the
greedy tokens with the ok bits, or, when sampling, the rows' logits, so
that one generator draws every row in the one-device order — and the host
logic (admission, the QoS degree from global occupancy, faults, policy,
harvest, statuses) stays one program on all ``D M`` ranks.  The quality
tap sums its squares over ``data``.

A fleet replica whose ranks do not span the world (``dist.fleet``:
``fleet_meshes``) is a :class:`SlotShard` too: its members hold every slot
and its first rank broadcasts the tick's emission (and the tap's value)
over the world; every other rank builds the same engine as a shadow
(``member`` False on its mesh), which holds no rows, keeps its parameters
and state on the meta device (their shapes give the fault draws) and
advances the replica's host state tick for tick from the broadcast.

Host decisions must be identical on every rank, or the ranks diverge and
a collective hangs or mixes two steps.  Everything the core decides from
its inputs is (slot admission, QoS rungs from occupancy, seeded fault
draws, greedy or seeded sampling on identical rows, guard bits and the
quality tap on gathered values); the one per-process source is the clock,
so a core on several ranks reads world rank 0's clock, broadcast over the
world (:class:`SharedClock`), unless a deterministic one
(``resil.VirtualClock``) is passed.  At drain the ranks' token streams
are all-gathered over the world and must be equal.

Two collective regimes on the decode path, as in the reference:

  * ``ring=False`` — exact f32 all-reduces of the row-parallel partials:
    sharded decode equals the same parameters served on one device, up to
    the order of the f32 sums;
  * ``ring=True`` — under EXACT the row-parallel reductions go through the
    int8 ring (``kernels/ops.py`` ``ring_tp``, opened around each tick):
    about a quarter of the bytes at a small reduction error.

The sharded step runs eagerly.  A gloo collective cannot be captured in a
CUDA graph, so ``capture=True`` under a gloo group raises; capture under
NCCL needs one card a rank (ROADMAP §A).  The MoE family on a data axis
raises: the reference's own sharded engine cannot serve it (its MoE block
splits the tokens' batch over the data axes inside ``shard_map``, and an
exact-length admission prefills one prompt, a batch of 1; ROADMAP §C).

:func:`lm_decode_collective_bytes` runs one decode step on the active
mesh and returns its collective bytes by kind from the collectives' byte
counters — the reference's probe of one compiled ``decode_step``, whose
logits stay sharded over ``model``; the engine's all-gather of the logits
for sampling is outside it, as it is outside the reference's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.transformer import check_tp_supported
from repro_torch.obs.quality import QualityTap, lm_logit_rms_probe
from repro_torch.resil import guards
from repro_torch.serve.engine import ServeCore
from repro_torch.serve.lm import LMAdapter, Request
from repro_torch.tree import tree_map


class SharedClock:
    """World rank 0's clock on every rank: each call is a broadcast over
    the world group, made at the same point of the program on every rank
    (the host logic is SPMD)."""

    def __init__(self, mesh: meshctx.Mesh, base=time.time):
        self.mesh = mesh
        self.base = base

    def __call__(self) -> float:
        t = self.base() if dist.get_rank() == 0 else 0.0
        return collectives.broadcast_value(t, meshctx.world_group(), self.mesh.device)


@dataclasses.dataclass(frozen=True)
class SlotShard:
    """Which of an engine's ``slots`` this rank computes, and how the
    tick's per-slot results reach every rank.  ``src`` None: a serving
    data axis, rows ``[lo, lo + n)`` gathered over ``group`` (the data
    group).  Else a fleet replica whose ranks do not span the world: its
    members hold every row (``n == slots``), the ranks outside it none
    (``n == 0``), and world rank ``src`` broadcasts over ``group`` (the
    world)."""

    slots: int
    lo: int
    n: int
    group: object = None
    src: Optional[int] = None

    def local(self, slot: int) -> Optional[int]:
        """``slot``'s row on this rank, or None if another rank holds it."""
        return slot - self.lo if self.lo <= slot < self.lo + self.n else None

    def mine(self, x):
        """This rank's rows of a per-slot ``x``."""
        return x[self.lo:self.lo + self.n]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every slot's rows on every rank from this rank's ``x``."""
        if self.src is None:
            return collectives.all_gather(x, self.group, dim=0)
        return collectives.broadcast_rows(x, self.slots, self.src, self.group)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks (a data axis), or the source's
        ``x`` on every rank (a fleet replica)."""
        if self.src is None:
            return collectives.all_reduce(x, self.group)
        return collectives.broadcast_rows(x.reshape(1, -1), 1, self.src,
                                          self.group).reshape(x.shape)


def slot_shard(mesh: meshctx.Mesh, slots: int) -> Optional[SlotShard]:
    """The :class:`SlotShard` of an engine of ``slots`` on ``mesh``; None
    when every rank computes every slot (a mesh that spans the world with
    no data axis).  A data axis must divide ``slots``."""
    data = [a for a in meshctx.batch_axes(mesh) if mesh.size(a) > 1]
    world = meshctx.world_size()
    if data:
        D = mesh.size(data[0])
        if len(data) > 1:
            raise NotImplementedError(f"slots sharded over {data}: one data axis is served")
        if slots % D:
            raise ValueError(f"slots={slots} do not divide over the data axis ({D} ranks)")
        if len(mesh.ranks) != world:
            raise NotImplementedError(
                f"a data axis on a mesh of {len(mesh.ranks)} of the world's {world} ranks: "
                "a fleet replica is a (1, tp) mesh")
        n = slots // D
        return SlotShard(slots, mesh.coord(data[0]) * n, n, group=mesh.group(data[0]))
    if len(mesh.ranks) < world:
        return SlotShard(slots, 0, slots if mesh.member else 0, group=meshctx.world_group(),
                         src=mesh.ranks[0])
    return None


def check_data_axis(cfg, mesh: meshctx.Mesh) -> None:
    """The MoE family on a data axis above 1 raises (module docstring)."""
    if getattr(cfg, "moe", None) and any(mesh.size(a) > 1 for a in meshctx.batch_axes(mesh)):
        raise NotImplementedError(
            "the MoE family on a serving data axis: the reference's own sharded engine "
            "cannot serve it (its MoE block splits the tokens' batch over the data axes "
            "inside shard_map, and an exact-length admission prefills one prompt, a batch "
            "of 1 that a data axis above 1 cannot divide; ROADMAP §C)")


def _meta_rows(cache, rows: int):
    """A meta-device cache of ``cache``'s fields with ``rows`` slots (the
    batch at axis 1, ``length``'s at 0): shapes without memory."""
    return type(cache)(*(
        torch.empty((rows,) + tuple(t.shape[1:]) if name == "length"
                    else (t.shape[0], rows) + tuple(t.shape[2:]), dtype=t.dtype, device="meta")
        for name, t in zip(cache._fields, cache)))


class ShardedLMAdapter(LMAdapter):
    """:class:`~repro_torch.serve.lm.LMAdapter` over a :class:`SlotShard`:
    the engine's host logic sees every slot; admission, the step, slot
    resets and the quality probe compute this rank's rows, and the tick's
    emission is gathered to every rank (module docstring)."""

    def __init__(self, model, shard: SlotShard, **kw):
        super().__init__(model, **kw)
        self.shard = shard
        if shard.n == 0:
            # a rank outside a fleet replica: host tensors on the CPU, the
            # parameters and state on the meta device (never computed on)
            self.device = torch.device("cpu")

    def init_state(self, *, batch: int, max_len: int):
        sh = self.shard
        if batch != sh.slots:
            raise ValueError(f"the engine's {batch} slots are not the shard's {sh.slots}")
        if sh.n == 0:
            one = build_model(self.cfg, self.model.policy, device="cpu")
            return _meta_rows(one.init_cache(tp=self.tp, batch=1, max_len=max_len), batch)
        return self.model.init_cache(tp=self.tp, batch=sh.n, max_len=max_len)

    def reset_slot(self, state, slot):
        local = self.shard.local(slot)
        return state if local is None else self.model.reset_slot(state, local)

    def admit(self, params, cache, feed, slot, req, degree):
        local = self.shard.local(slot)
        if local is not None:
            # this rank's rows of the feed (a view: the writes land in it)
            return super().admit(params, cache, self.shard.mine(feed), local, req, degree)
        prompt = req.payload
        ingested = int(prompt.size) - 1 if prompt.size > 1 else 0
        if ingested:
            self._note("prefill", (ingested,))
        feed[slot, 0] = int(prompt[-1])
        req.cursor = ingested
        return cache, ingested

    def _prefill_batch(self, params, cache, host: dict, degree, run: bool = True):
        """The bucketed call on this rank's rows: the others become dummy
        rows (slot = the local row count, writing nothing); a call with
        none of this rank's rows is skipped, one of dummies alone (warmup)
        runs."""
        sh = self.shard
        slots = host["slots"]
        local = np.asarray([-1 if s >= sh.slots or sh.local(int(s)) is None
                            else sh.local(int(s)) for s in slots], np.int64)
        mine = local >= 0
        if sh.n == 0 or (run and not mine.any() and (slots < sh.slots).any()):
            self._note("prefill_batch", tuple(host["tokens"].shape))
            return
        h = {"tokens": np.where(mine[:, None], host["tokens"], 0),
             "slots": np.where(mine, local, sh.n),
             "lengths": np.where(mine, host["lengths"], 0)}
        super()._prefill_batch(params, cache, h, degree, run)

    def _prefill_chunk(self, params, cache, host: dict, degree, run: bool = True):
        """The chunk call on the slot's owner (the dummy slot everywhere)."""
        sh = self.shard
        s = int(host["slot"])
        local = sh.n if s >= sh.slots else sh.local(s)
        if sh.n == 0 or local is None:
            self._note("prefill_chunk", tuple(host["tokens"].shape))
            return
        super()._prefill_chunk(params, cache, dict(host, slot=np.asarray(local, np.int64)),
                               degree, run)

    def _logits(self, params, cache, feed, active, degree):
        sh = self.shard
        if sh.n == 0:
            self._note("step", (tuple(feed.shape), None if degree is None
                                else tuple(getattr(degree, "shape", ()))))
            return torch.zeros((0, self.cfg.vocab), dtype=torch.float32), cache
        return super()._logits(params, cache, sh.mine(feed), sh.mine(active), degree)

    def _tokens(self, logits, generator):
        if logits.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.int32)
        return self._sample(logits, generator)

    def _gathers_logits(self) -> bool:
        """A sampled data axis gathers the rows' logits before sampling:
        one generator then draws every row in the one-device order."""
        return self.shard.src is None and not self.greedy

    def step(self, params, cache, feed, active, generator, degree):
        logits, cache = self._logits(params, cache, feed, active, degree)
        if self._gathers_logits():
            return self._sample(self.shard.gather(logits), generator), cache
        return self.shard.gather(self._tokens(logits, generator)), cache

    def guarded_step(self, params, cache, feed, active, generator, degree, fault):
        sh = self.shard
        logits, cache = self._logits(params, cache, feed, active, degree)
        lv = kdispatch.inject_fault(logits, sh.mine(fault)) if sh.n else logits
        if self._gathers_logits():
            lv = sh.gather(lv)
        ok = guards.slot_ok(lv, limit=self.guard_limit)
        safe = torch.where(torch.isfinite(lv), lv, torch.zeros_like(lv))
        if self._gathers_logits():
            return self._sample(safe, generator), cache, ok
        tok = self._tokens(safe, generator)
        both = sh.gather(torch.stack([tok.to(torch.int64), ok.to(torch.int64)], dim=1))
        return both[:, 0].to(torch.int32), cache, both[:, 1] != 0

    def quality_tap(self, *, every, registry, tracer):
        """The logit-RMS tap over every slot: a data axis sums the probe's
        squares over ``data``; a fleet replica's first rank sends its
        value to the world."""
        sh = self.shard
        data = sh.src is None
        base = lm_logit_rms_probe(self.model, tp=self.tp, reduce=sh.total if data else None)

        def probe(params, state, feed, active, degree, exact):
            if data:
                return base(params, state, sh.mine(feed), sh.mine(active), degree, exact)
            val = (base(params, state, feed, active, degree, exact) if sh.n
                   else torch.zeros((), dtype=torch.float32))
            return sh.total(val.to(torch.float32))

        return QualityTap(probe=probe, every=every, registry=registry, tracer=tracer)


class ShardedServeCore(ServeCore):
    """:class:`~repro_torch.serve.engine.ServeCore` on ``mesh`` (default:
    the active mesh): ``params`` is the global float tree, cut here to this
    rank's shards and then packed on the shards; every construction step
    and tick runs under the mesh and, with ``ring=True``, the int8-ring
    lever (no-op on a 1-wide model axis).  A data axis, or a mesh that does
    not span the world (a fleet replica), needs a workload with a
    :class:`SlotShard` (:class:`ShardedLMAdapter`).  Everything else is the
    generic core."""

    def __init__(self, workload, params, *, mesh: Optional[meshctx.Mesh] = None,
                 ring: bool = False, capture: Optional[bool] = None, clock=None, **kw):
        self.mesh = mesh if mesh is not None else meshctx.get_mesh()
        tp = self.mesh.size("model")
        world = meshctx.world_size()
        self.shard = getattr(workload, "shard", None)
        spread = len(self.mesh.ranks) < world or any(
            self.mesh.size(a) > 1 for a in meshctx.batch_axes(self.mesh))
        if spread and self.shard is None:
            raise NotImplementedError(
                "a serving data axis, or a fleet replica on a slice of the ranks, needs the "
                "LM workload's slot shard (ShardedServeEngine); the stream workload serves "
                "on one device")
        check_data_axis(workload.cfg, self.mesh)
        several = tp > 1 or world > 1
        if capture and several:
            if self.mesh.backend == "gloo" or (world > 1 and dist.get_backend() == "gloo"):
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
        if clock is None and world > 1:
            clock = SharedClock(self.mesh)
        shadow = self.shard is not None and self.shard.n == 0
        with self._mesh_ctx():
            if shadow:
                # a rank outside the replica: the shapes of coordinate 0's
                # shards, on the meta device
                params = tree_map(lambda t: t.to("meta"), params)
            if tp > 1:
                cut = (meshctx.Mesh(self.mesh.shape, self.mesh.axis_names, device="meta")
                       if shadow else self.mesh)
                params = sharding.shard_params(params, mesh=cut)
            super().__init__(workload, params, capture=False if several else capture,
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

    def _flip_state(self, ev) -> None:
        """A ``seu_state`` flip lands on the flipped slot's owner."""
        local = ev.slot if self.shard is None else self.shard.local(ev.slot)
        if local is not None:
            self.state = self.faults.apply_state(self.state,
                                                 dataclasses.replace(ev, slot=local))

    def params_golden(self) -> bool:
        if self.shard is not None and self.shard.n == 0:
            return True                      # a shadow holds no parameters
        return super().params_golden()

    def streams(self) -> list:
        """(rid, status, tokens) of every finished request, by rid."""
        return [(r.rid, r.status, tuple(r.out)) for r in sorted(self.done, key=lambda r: r.rid)]

    def check_streams(self) -> None:
        """All-gather the ranks' streams over the world; raises unless they
        are equal."""
        check_equal_streams(self.streams())

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        """:meth:`ServeCore.run_until_drained`, then :meth:`check_streams`."""
        done = super().run_until_drained(max_ticks)
        self.check_streams()
        return done


def check_equal_streams(mine) -> None:
    """All-gather ``mine`` over the world; raises unless every rank's is
    equal (a no-op with one rank)."""
    g = meshctx.world_group()
    if g is None:
        return
    got = [None] * dist.get_world_size(g)
    dist.all_gather_object(got, mine, group=g)
    bad = [r for r, s in enumerate(got) if s != mine]
    if bad:
        raise RuntimeError(f"the ranks' token streams diverged (ranks {bad} differ from "
                           f"rank {dist.get_rank()})")


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
        check_data_axis(model.cfg, mesh)
        shard = slot_shard(mesh, slots)
        adapter = (LMAdapter if shard is None
                   else functools.partial(ShardedLMAdapter, shard=shard))
        workload = adapter(model, tp=tp, eos_id=eos_id, greedy=greedy,
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
