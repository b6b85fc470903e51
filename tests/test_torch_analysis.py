"""The port's analysis (``repro_torch.dist.hlo_analysis``): one step's work
counted on the meta device, against analytic counts and against the
reference's ``repro.dist.hlo_analysis.analyze_hlo``.

* Each router's meta route reaches its kernel's op
  (``kernels/meta_ops.py``), whose logical work the analysis counts: an
  AXQ GEMM 2 M N K under ``s32`` (packed and float weights), the gated
  core twice that, an expert batch E times; prefill attention QK^T and PV over the
  extent of the reference's jnp attention (the whole S x S at up to 512
  positions, ``tri`` included; a window's span beyond), decode over the
  whole cache on both caches; ``aten._int_mm``, which
  ``torch.utils.flop_counter`` does not count, is counted.
* tinyllama-1.1b-smoke in f32 under EXACT and axq8 at (1, 1): the prefill
  forward and ``serve_step`` give the reference's dot FLOPs dtype by dtype,
  equal, and the train step the reference's plus the products named in
  :func:`test_train_step_matches_reference_but_the_named_dots`.  The
  reference's walker reads a dot's contracted dims from its operands'
  shapes, which this jax's ``as_text()`` no longer prints (the seed's
  ``test_hlo_analysis.py::test_scan_trip_count_multiplies_flops`` fails for
  that reason): the test writes each operand's shape, from the instruction
  that defines it, back into the text before ``analyze_hlo`` reads it.
* One spawn of two gloo ranks: the dry run's collective calls and bytes by
  kind equal the live ``collectives.counter``'s for one decode tick at
  tp = 2 (exact all-reduce and the int8 ring) and one train step at 1x2.
* The meta route is reached by meta tensors alone.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import pytest
import torch
from functools import partial

import _torch_analysis as A
from repro.configs import get_config as jget_config
from repro.core.approx import policy_from_flag as jpolicy
from repro.dist.hlo_analysis import analyze_hlo
from repro.models import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.core.approx import policy_from_flag as tpolicy
from repro_torch.dist import collectives, meshctx
from repro_torch.dist import hlo_analysis as H
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import dispatch as D
from repro_torch.kernels import meta_ops
from repro_torch.kernels.qstore import PackedQWeight
from repro_torch.models import attention as tattn
from repro_torch.models import build_model as tbuild_model
from repro_torch.train import step as tstep

torch.set_num_threads(2)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _pack(*lead, n, k, bk):
    return PackedQWeight(_meta(*lead, n, k, dtype=torch.int8), _meta(*lead, n, k // bk))


def _count(fn, *args):
    rep = H.analyze_step(fn, *args)
    return rep, rep.dot_flops_by_dtype


# ---------------------------------------------------------------------------
# analytic counts of each route
# ---------------------------------------------------------------------------


def test_aten_products_and_int_mm():
    """``mm`` through flop_counter's formula (f32), ``_int_mm`` counted by
    the mode itself (s32): FlopCounterMode alone reads the ``mm`` only."""
    from torch.utils.flop_counter import FlopCounterMode

    x, w = _meta(64, 128), _meta(128, 32)
    a, b = _meta(32, 64, dtype=torch.int8), _meta(64, 32, dtype=torch.int8)
    fn = lambda x, w, a, b: (x @ w, torch._int_mm(a, b))
    with FlopCounterMode(display=False) as fc:
        fn(x, w, a, b)
    assert fc.get_total_flops() == 2 * 64 * 128 * 32
    rep, by = _count(fn, x, w, a, b)
    assert by == {"f32": 2 * 64 * 128 * 32, "s32": 2 * 32 * 64 * 32}
    assert [d[0] for d in rep.dots] == ["aten.mm", "aten._int_mm"]
    assert rep.output[1].dtype == torch.int32 and rep.output[1].shape == (32, 32)


@pytest.mark.parametrize("weights", ["packed", "float"])
def test_gemm_routers_count_their_products(weights):
    """axq_matmul 2 M N K, axq_gated 4 M N K, the expert batches E times,
    all under s32, each returning the kernel's (.., N) f32 output."""
    M, K, N, bk, E, C = 8, 128, 96, 64, 4, 6
    if weights == "packed":
        w, wu, wg = (_pack(n=N, k=K, bk=bk) for _ in range(3))
        we, weu, weg = (_pack(E, n=N, k=K, bk=bk) for _ in range(3))
    else:
        w, wu, wg = (_meta(K, N) for _ in range(3))
        we, weu, weg = (_meta(E, K, N) for _ in range(3))
    x, x3 = _meta(M, K), _meta(E, C, K)
    calls = [(lambda: D.axq_matmul(x, w, block=bk), 2 * M * N * K, (M, N), "axqmm"),
             (lambda: D.axq_gated(x, wu, wg, block=bk), 4 * M * N * K, (M, N), "axqmm_gated"),
             (lambda: D.axq_matmul_experts(x3, we, block=bk), 2 * E * C * N * K, (E, C, N),
              "axqmm_experts"),
             (lambda: D.axq_gated_experts(x3, weu, weg, block=bk), 4 * E * C * N * K,
              (E, C, N), "axqmm_gated_experts")]
    for fn, flops, shape, op in calls:
        rep, by = _count(fn)
        assert by == {"s32": flops}
        assert [d[0] for d in rep.dots] == [f"repro_torch.{op}"]
        assert rep.output.shape == shape and rep.output.dtype == torch.float32
    assert D.last_route["gemm"] == D.last_route["gated"] == "meta"


@pytest.mark.parametrize("schedule", ["tri", "dense", "band"])
def test_prefill_attention_counts(schedule):
    """QK^T and PV over the whole S x S at smoke shapes whatever the
    schedule (the reference's one-shot jnp attention), PV in v's dtype; at
    S = 2048 the reference's 512-position blocks in f32: the whole S for
    ``tri`` / ``dense``, a window of 128 reaching ceil(640 / 512) = 2 kv
    blocks of 512 for ``band``."""
    causal = schedule != "dense"
    window = 8 if schedule == "band" else None
    B, S, H, KVr, D_ = 2, 16, 4, 2, 16
    q, k, v = (_meta(B, S, n, D_, dtype=torch.bfloat16) for n in (H, KVr, KVr))
    rep, by = _count(lambda: D.prefill_attention(q, k, v, causal=causal, window=window))
    f = 2 * B * H * S * S * D_
    assert by == {"f32": f, "bf16": f}
    assert rep.output.shape == q.shape and rep.output.dtype == torch.bfloat16
    S = 2048
    q, k, v = (_meta(1, S, n, D_) for n in (H, KVr, KVr))
    _, by = _count(lambda: D.prefill_attention(q, k, v, causal=causal,
                                               window=128 if window else None))
    assert by == {"f32": 2 * 2 * H * S * (1024 if window else S) * D_}


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_decode_attention_counts(quant):
    """One token against the whole cache (T positions): 2 x 2 B H T D in
    f32 on either cache; the output (B, 1, H, D) and the length + 1."""
    B, T, H, KVr, D_ = 3, 40, 4, 2, 16
    if quant:
        cache = tattn.QuantKVCache(_meta(B, T, KVr, D_, dtype=torch.int8),
                                   _meta(B, T, KVr, D_, dtype=torch.int8), _meta(B, T, KVr),
                                   _meta(B, T, KVr), _meta(B, dtype=torch.int32))
    else:
        cache = tattn.KVCache(_meta(B, T, KVr, D_, dtype=torch.bfloat16),
                              _meta(B, T, KVr, D_, dtype=torch.bfloat16),
                              _meta(B, dtype=torch.int32))
    q1, kn, vn = (_meta(B, 1, n, D_, dtype=torch.bfloat16) for n in (H, KVr, KVr))
    rep, by = _count(lambda: D.decode_attention(q1, kn, vn, cache, degree=None))
    assert by == {"f32": 2 * 2 * B * H * T * D_}
    out, new = rep.output
    assert out.shape == (B, 1, H, D_) and out.dtype == torch.bfloat16
    assert new.length.shape == (B,)


def test_collectives_on_a_meta_mesh():
    """On a meta mesh every collective counts what it would send (the
    live path's bytes and calls) and returns its result's shape; a tensor
    with data on a meta axis raises; the multi-pod batch axes raise as on a
    live mesh (one data axis is supported)."""
    mesh = meshctx.make_meta_mesh((2, 4), ("data", "model"), rank=5)
    g = mesh.group("model")
    assert (g.size, g.rank, mesh.coord("data"), mesh.group("data").rank) == (4, 1, 1, 1)
    x = _meta(3, 10)
    collectives.counter.reset()
    with H._fresh_counter() as ctr:
        assert collectives.all_reduce(x, g).shape == (3, 10)
        assert collectives.all_gather(x, g, dim=-1).shape == (3, 40)
        assert collectives.ring_allreduce_int8(x, g).shape == (3, 10)
        assert collectives.broadcast_rows(_meta(1, 5), 2, 0, mesh.group("data")).shape == (2, 5)
        assert collectives.gather_kv_heads(x, g).shape == (3, 40)
    assert ctr.bytes == {"all-reduce": 120, "all-gather": 240,
                         "collective-permute": 2 * 3 * (8 + 4), "broadcast": 40}
    assert ctr.calls == {"all-reduce": 1, "all-gather": 2, "collective-permute": 6,
                         "broadcast": 1}
    assert collectives.counter.snapshot()["total"] == 0        # the live counter untouched
    with pytest.raises(ValueError, match="meta tensors"):
        collectives.all_reduce(torch.zeros(3), g)
    pod = meshctx.make_meta_mesh((2, 16, 16), ("pod", "data", "model"), rank=300)
    with pytest.raises(NotImplementedError, match="one data axis is supported"):
        meshctx.data_group(pod)


def test_meta_route_is_reached_by_meta_tensors_alone(monkeypatch):
    """A CPU tensor still takes the plain version (equal to it) and a meta
    tensor the meta route under every setting; ``cuda`` with a CPU tensor
    still raises, and a CUDA device resolves to the kernel."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4, 64, generator=gen)
    w = torch.randn(64, 32, generator=gen)
    pw = taxq.prepack_weight(w, 64)
    y = D.axq_matmul(x, pw, block=64)
    assert D.last_route["gemm"] == "torch"
    assert torch.equal(y, taxq.axqmm_packed_plain(x, pw, 8))
    assert torch.equal(taxq.axqmm_packed(x, pw, 8), y)
    assert D.resolved_backend("cuda") == "cuda" and D.resolved_backend("cpu") == "torch"
    for setting in ("auto", "torch", "cuda"):
        monkeypatch.setenv("REPRO_TORCH_KERNELS", setting)
        assert D.resolved_backend("meta") == "meta"
        out = D.axq_matmul(_meta(4, 64), PackedQWeight(pw.qw.to("meta"), pw.scales.to("meta")))
        assert out.device.type == "meta" and D.last_route["gemm"] == "meta"
    with pytest.raises(RuntimeError, match="requested for a tensor on the CPU"):
        D.axq_matmul(x, pw, block=64)
    # the kernels' ops have no CPU (or CUDA) implementation: a tensor with
    # data that reached one would raise, never return an empty result
    with pytest.raises(NotImplementedError, match="CPU"):
        meta_ops.axqmm(x, pw.qw)


def test_memory_report_holds_the_state_bytes():
    """``argument_bytes`` of a meta train step equal the bytes of the same
    state built live on the CPU (and its batch), each storage once; the
    output holds the new state; the peak holds the arguments."""
    cfg = dataclasses.replace(tget_config(A.ARCH), dtype="float32")
    live = tstep.init_state(tbuild_model(cfg, device="cpu"))
    mm = tbuild_model(cfg, device="meta")
    meta = tstep.init_state(mm)
    batch = {k: _meta(2, 16, dtype=torch.int64) for k in ("tokens", "labels")}
    rep = H.analyze_step(tstep.train_step, mm, tstep.StepConfig(remat="none"), meta, batch)
    state_bytes = H.tree_bytes(live)
    assert rep.memory.argument_bytes == state_bytes + 2 * 2 * 16 * 8
    new_state, metrics = rep.output
    assert H.tree_bytes(new_state) == state_bytes
    assert rep.memory.output_bytes >= state_bytes
    assert rep.memory.peak_bytes > rep.memory.argument_bytes
    with pytest.raises(ValueError, match="meta tensors"):
        H.analyze_step(lambda t: t, torch.zeros(2))


# ---------------------------------------------------------------------------
# against the reference's HLO analysis
# ---------------------------------------------------------------------------


def _shaped(text: str) -> str:
    """The HLO text with each dot operand's shape written before its name
    (taken from the instruction that defines the operand), the form the
    reference's walker reads the contracted dims from."""
    defs = dict(re.findall(r"%([\w.\-]+) = ([a-z0-9]+\[[0-9,]*\])", text))

    def fix(m):
        ops = re.sub(r"%([\w.\-]+)", lambda o: f"{defs[o.group(1)]} %{o.group(1)}", m.group(2))
        return f"{m.group(1)}{ops})"

    return re.sub(r"(\bdot\()([^)]*)\)", fix, text)


def _ref(fn, *args):
    return analyze_hlo(_shaped(jax.jit(fn).lower(*args).compile().as_text()))


def _models(approx):
    jcfg = dataclasses.replace(jget_config(A.ARCH), dtype="float32")
    tcfg = dataclasses.replace(tget_config(A.ARCH), dtype="float32")
    jm = jbuild_model(jcfg, jpolicy(approx, dynamic=True))
    tm = tbuild_model(tcfg, tpolicy(approx, dynamic=True), device="meta")
    return jcfg, jm, tm


@pytest.mark.parametrize("approx", ["exact", "axq8"])
def test_prefill_and_decode_match_reference_dtype_by_dtype(approx):
    """The prefill forward (B 2 x S 16) and ``serve_step`` (2 slots, a
    cache of 32) on (1, 1): every dtype's dot FLOPs equal the reference's
    (analytic too: its walker and the port's count agree dot by dot)."""
    B, S, T = 2, 16, 32
    _, jm, tm = _models(approx)
    jp = jax.eval_shape(partial(jm.init, tp=1), jax.random.PRNGKey(0))
    tp_ = tm.init(seed=0)
    if approx != "exact":
        jp, tp_ = jax.eval_shape(jm.prepack, jp), tm.prepack(tp_)
    ref = _ref(lambda p, b: jm.forward(p, b, tp=1, remat="dots")[0], jp,
               {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    port = H.analyze_step(lambda p, b: tm.forward(p, b, tp=1, remat="dots")[0], tp_,
                          {"tokens": _meta(B, S, dtype=torch.int32)})
    assert port.dot_flops_by_dtype == ref.dot_flops_by_dtype
    ref = _ref(lambda p, c, t: jstep.serve_step(jm, p, c, t, tp=1), jp,
               jax.eval_shape(partial(jm.init_cache, 1, B, T)),
               jax.ShapeDtypeStruct((B, 1), jnp.int32))
    port = H.analyze_step(lambda p, c, t: tstep.serve_step(tm, p, c, t, tp=1), tp_,
                          tm.init_cache(1, B, T), _meta(B, 1, dtype=torch.int32))
    assert port.dot_flops_by_dtype == ref.dot_flops_by_dtype
    assert port.dot_flops == ref.dot_flops > 0


@pytest.mark.parametrize("approx", ["exact", "axq8"])
def test_train_step_matches_reference_but_the_named_dots(approx):
    """One train step (B 2 x S 16, remat full) on (1, 1): the port's dot
    FLOPs are the reference's plus, dtype by dtype (ROADMAP §C):

    * f32, each layer: the attention oracle's own forward, one QK^T and one
      PV over S x S (``flash_attention_ref`` rebuilds the scores it
      differentiates; the reference differentiates its jnp attention from
      the remat recompute);
    * s32 (axq8), each layer: one more 2 M N K product of up, of gate and of
      down.  The reference's block runs each GEMM three times (forward,
      remat recompute, the custom VJP's recompute of ``qmm_ref``) but XLA
      drops the recompute of down, whose output nothing reads; the port's
      checkpoint recomputes the whole block, and its gated oracle forms
      the up and gate products once to rebuild the gate's input and once
      for their scale gradients (the reference's VJP recomputes each
      once)."""
    B, S = 2, 16
    cfg, jm, tm = _models(approx)
    jstate = jax.eval_shape(partial(jstep.init_state, jm, tp=1), jax.random.PRNGKey(0))
    jb = {k: jax.ShapeDtypeStruct((B, S), jnp.int32) for k in ("tokens", "labels")}
    ref = _ref(partial(jstep.train_step, jm, jstep.StepConfig(remat="full"), tp=1), jstate, jb)
    port = H.analyze_step(tstep.train_step, tm, tstep.StepConfig(remat="full"),
                          tstep.init_state(tm), {k: _meta(B, S, dtype=torch.int32)
                                                 for k in ("tokens", "labels")})
    Lyr, d, H_, Dh, M = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim, B * S
    extra = {"f32": Lyr * 2 * (2 * B * H_ * S * S * Dh)}
    if approx != "exact":
        extra["s32"] = Lyr * 3 * (2 * M * d * cfg.d_ff)
    want = {k: v + extra.get(k, 0) for k, v in ref.dot_flops_by_dtype.items()}
    assert port.dot_flops_by_dtype == want
    oracle = [f for w, _, f in port.dots if w == "aten.bmm"]
    assert len(oracle) == Lyr * 6                # the oracle: 2 forward + 4 backward


# ---------------------------------------------------------------------------
# the dry run's collectives against the live counter on gloo ranks
# ---------------------------------------------------------------------------


def test_meta_collectives_equal_the_live_counter():
    """Two gloo ranks: one decode tick at tp = 2 (the exact all-reduces and,
    under the ring lever, the int8 ring's hops) and one train step at 1x2
    and at 2x1 (the data axis), each rank's live calls and bytes by kind
    == the dry run's on rank 0's meta mesh."""
    jobs = [((1, 2), "cpu", False, False), ((1, 2), "cpu", True, False),
            ((1, 2), "cpu", False, True), ((2, 1), "cpu", False, True)]
    live = meshctx.spawn_ranks(A.counts_rank, 2, args=(jobs,), timeout_s=A.TIMEOUT_S)
    assert live[0] == live[1]
    for job, got in zip(jobs, live[0]):
        shape, _, ring, train = job
        assert got == A.step_counts(shape, "meta", ring, train), job
        # the ring: wo's and down's partials in each of the 2 layers, 2 hops each
        assert got["calls"].get("collective-permute", 0) == (2 * 2 * 2 if ring else 0)
