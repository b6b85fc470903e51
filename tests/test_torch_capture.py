"""The capture-ready serve step on the CPU: the device-side write plans of
the bucketed prefill and the prefill chunk, the calls a capturing engine
replays from CUDA graphs reading nothing on the host, and the graph set's
launch bookkeeping on a stub graph.  (The captures themselves need the
card: tests/test_torch_gpu.py.)

Bit-identity claims, at fixed seeds: ``lm_prefill_batch`` with its write
plan on the device writes the same cache bytes as the host-side plan it
replaced and as the reference's ``lm_prefill_batch`` — on f32, bf16 and
int8 caches, with dummy rows, zero-length rows, more rows than slots and a
ring with the bucket longer than the ring.  To compare the plans across
frameworks bit for bit, the block forward is replaced on both sides by
the same exact function of the embedded tokens and their positions (the
frameworks' float kernels differ in the last ulp).  ``lm_prefill_chunk``
with device scalars equals the host-sliced version it replaced bit for
bit, and the reference's within 1e-4 (f32: the attention's reductions run
in another order); a dummy chunk leaves the cache as it was in both."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.models import transformer as JT
from repro_torch.convert import cache_from_numpy
from repro_torch.core.dynamic import QoSController
from repro_torch.kernels import _build
from repro_torch.models import attention as tattn
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.cache_ops import cache_reset_slot
from repro_torch.serve import graphs as tgraphs
from repro_torch.serve import stream as tstream
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

DANUBE = "h2o-danube-1.8b-smoke"
#: KVr * head_dim of the smoke archs (d_model 64 holds K and V side by side)
KD = 32


# ---------------------------------------------------------------------------
# the bucketed prefill's write plan
# ---------------------------------------------------------------------------


def _kv(x, positions, f32, cast):
    """The same exact K/V in both frameworks: the embedded row doubled and
    its position added, in f32, rounded once to the model dtype."""
    N, S = x.shape[0], x.shape[1]
    pos = f32(positions)[..., None]
    k = cast(f32(x[..., :KD]) * 2.0 + pos * 0.25)
    v = cast(f32(x[..., KD:2 * KD]) - pos * 0.5)
    return k.reshape(N, S, 2, KD // 2), v.reshape(N, S, 2, KD // 2)


def _jblock(bp, x, cfg, tp, policy, path, positions, degree=None, return_kv=False):
    kv = _kv(x, positions, lambda a: a.astype(jnp.float32), lambda a: a.astype(x.dtype))
    return x, jnp.zeros((), jnp.float32), kv


def _tblock(bp, x, cfg, tp, policy, path, positions, degree=None, return_kv=False):
    return x, _kv(x, positions, lambda a: a.to(torch.float32), lambda a: a.to(x.dtype))


def _host_plan_prefill_batch(params, cfg, policy, cache, tokens, slots, lengths):
    """The host-side write plan ``lm_prefill_batch`` had before its plan
    moved to the device: slots and lengths read on the host, live slots
    reset one by one, the index lists built in Python."""
    N, Pb = tokens.shape
    B, T = cache.k.shape[1], cache.k.shape[2]
    live, live_len, rows, src, dsl, dst = [], [], [], [], [], []
    for r, (s, n) in enumerate(zip(slots, lengths)):
        if not 0 <= s < B:
            continue
        live.append(s)
        live_len.append(n)
        for j in range(max(n - T, 0), n):
            rows.append(r)
            src.append(j)
            dsl.append(s)
            dst.append(j % T)
    as_t = lambda xs: torch.tensor(xs, dtype=torch.int64)
    rows, src, dsl, dst = map(as_t, (rows, src, dsl, dst))
    for s in live:
        cache_reset_slot(cache, s)
    x = TL.embed_apply(params["embed"], tokens, TT._dtype(cfg))
    positions = torch.arange(Pb, dtype=torch.int32)[None].expand(N, Pb)
    for i in range(cfg.n_layers):
        x, (k, v) = TT.block_apply(TT.layer_params(params["layers"], i), x, cfg, 1,
                                   policy, "layer", positions, None, return_kv=True)
        if rows.numel():
            TT._write_kv(cache, i, dsl, dst, k[rows, src], v[rows, src])
    if live:
        cache.length[torch.tensor(live)] = torch.tensor(live_len, dtype=torch.int32)
    return cache


def _random_cache(rng, cfg, B, T, kind):
    """A cache full of seeded garbage (so resets and untouched slots show),
    as the reference's NamedTuple and the port's."""
    L, shape = cfg.n_layers, (cfg.n_layers, B, T, 2, KD // 2)
    length = rng.integers(0, T + 1, B).astype(np.int32)
    if kind == "int8":
        f = (rng.integers(-127, 128, shape).astype(np.int8),
             rng.integers(-127, 128, shape).astype(np.int8),
             rng.uniform(0, 1, shape[:4]).astype(np.float32),
             rng.uniform(0, 1, shape[:4]).astype(np.float32), length)
        jc = JT.LMCacheQ(*map(jnp.asarray, f))
    else:
        dt = jnp.float32 if kind == "f32" else jnp.bfloat16
        f = (rng.standard_normal(shape), rng.standard_normal(shape))
        jc = JT.LMCache(jnp.asarray(f[0], dt), jnp.asarray(f[1], dt), jnp.asarray(length))
    assert L == 2
    return jc, cache_from_numpy(jax.tree.map(np.asarray, jc))


#: (arch, B, max_len, Pb, slots (B = a dummy), lengths)
BATCH_CASES = {
    "live+dummy+empty": (P.ARCH, 4, 32, 16, [2, 0, "B", 3], [5, 16, 9, 0]),
    "rows>slots": (P.ARCH, 2, 32, 16, ["B", 1, "B", 0, "B"], [4, 7, 0, 16, 12]),
    "all-dummy": (P.ARCH, 3, 32, 16, ["B", "B", "B"], [5, 9, 16]),
    "ring Pb>T": (DANUBE, 3, 32, 64, [1, "B", 0, 2], [50, 64, 64, 0]),
    "ring short": (DANUBE, 3, 32, 64, [2, 0, "B"], [33, 31, 7]),
}


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_prefill_batch_device_plan_bit_identical(case, kind, monkeypatch):
    """The device-side write plan against the host-side plan it replaced
    and the reference's ``lm_prefill_batch``, every cache field bit for
    bit."""
    arch, B, max_len, Pb, slots, lens = BATCH_CASES[case]
    slots = [B if s == "B" else s for s in slots]
    jm, jp, tm, tp = P.models("float32", "axq8", arch=arch)
    monkeypatch.setattr(JT, "block_apply", _jblock)
    monkeypatch.setattr(TT, "block_apply", _tblock)
    rng = np.random.default_rng(sum(map(ord, case + kind)))
    toks = rng.integers(1, 512, (len(slots), Pb))
    T = min(max_len, tm.cfg.swa_window or max_len)
    jc, tc = _random_cache(rng, tm.cfg, B, T, kind)
    old = _host_plan_prefill_batch(tp, tm.cfg, tm.policy, _snap(tc), torch.from_numpy(toks),
                                   slots, lens)
    new = tm.prefill_batch(tp, tc, torch.from_numpy(toks), torch.tensor(slots),
                           torch.tensor(lens))
    ref = jm.prefill_batch(jp, jc, jnp.asarray(toks, jnp.int32),
                           jnp.asarray(slots, jnp.int32), jnp.asarray(lens, jnp.int32))
    assert new is tc
    for f in type(new)._fields:
        a = getattr(new, f)
        assert torch.equal(a, getattr(old, f)), f"{case} {kind}: {f} vs the host plan"
        np.testing.assert_array_equal(P.to_np(a), np.asarray(getattr(ref, f), np.float32),
                                      err_msg=f"{case} {kind}: {f} vs the reference")


def test_device_plan_indexes_what_the_host_plan_indexed():
    """The plan's (row, token, slot, ring position) writes are the host
    plan's, and its dummy rows target distinct slots no live row writes."""
    B, T, Pb = 3, 8, 20
    slots = torch.tensor([1, B, 0, B, 2, -1])
    lens = torch.tensor([20, 3, 5, 0, 0, 9])
    plan = TT._batch_write_plan(slots, lens, B, T, Pb)
    got = {(r, int(plan.src[r, t]), int(plan.target[r]), t)
           for r in range(6) for t in range(T) if plan.valid[r, t]}
    want = {(r, j, int(s), j % T) for r, (s, n) in enumerate(zip(slots, lens))
            if 0 <= s < B for j in range(max(int(n) - T, 0), int(n))}
    assert got == want
    for r0, r1 in TT._row_groups(6, B):
        tgt = plan.target[r0:r1].tolist()
        assert len(set(tgt)) == len(tgt) and all(0 <= s < B for s in tgt)
    assert plan.live.tolist() == [True, False, True, False, True, False]


# ---------------------------------------------------------------------------
# the prefill chunk with device scalars
# ---------------------------------------------------------------------------


def _host_chunk(params, cfg, policy, cache, tokens, slot, offset, clen):
    """``lm_prefill_chunk`` as it was before its slot, offset and length
    became device scalars: a Python branch on the slot, host slicing."""
    pd = cfg.padded(1)
    C = tokens.shape[0]
    B, T, kvh = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    live = 0 <= slot < B
    take = max(min(clen, T - offset), 0)
    x = TL.embed_apply(params["embed"], tokens[None], TT._dtype(cfg))
    j = torch.arange(C, dtype=torch.int32)
    positions = (offset + j)[None]
    qmask = torch.arange(T)[None, :] <= (offset + j)[:, None]
    for i in range(cfg.n_layers):
        lp = TT.layer_params(params["layers"], i)
        hn = TL.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        q, k, v = TT._qkv(lp, hn, cfg, 1, policy, "layer", positions, None)
        if live:
            keys, vals = cache.k[i, slot], cache.v[i, slot]
        else:
            keys, vals = torch.zeros_like(cache.k[i, 0]), torch.zeros_like(cache.v[i, 0])
        keys[offset:offset + take] = k[0, :take].to(keys.dtype)
        vals[offset:offset + take] = v[0, :take].to(vals.dtype)
        qg = tattn._group_q(q, kvh)
        s = torch.einsum("bqkgd,tkd->bkgqt", qg.to(torch.float32),
                         keys.to(torch.float32)) / np.sqrt(cfg.head_dim)
        s = torch.where(qmask[None, None, None], s, tattn.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,tkd->bqkgd", p, vals.to(torch.float32))
        o = o.reshape(1, C, pd.n_heads * cfg.head_dim).to(x.dtype)
        x = TL.dense_apply(lp["wo"], o, policy, "layer/wo", None, residual=x)
        hn = TL.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps)
        x = TL.gated_mlp_apply(lp["mlp"], hn, policy, "layer/mlp", cfg.act, None, residual=x)
    if live:
        cache.length[slot] = offset + clen
    return cache


def _snap(cache):
    return type(cache)(*(t.clone() for t in cache))


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prefill_chunk_device_scalars_match_host_and_reference(cache_dtype):
    """A 21-token prefix into slot 1 in chunks of 8 (offsets 0, 8, 16; the
    last chunk runs past its 5 real tokens), then a dummy chunk (slot B):
    the device-scalar chunk equals the host-sliced one bit for bit and the
    reference's within 1e-4; the dummy chunk changes no byte on either
    side."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    rng = np.random.default_rng(21)
    prefix = rng.integers(1, 512, 21)
    B, C = 3, 8
    jc = jm.init_cache(tp=1, batch=B, max_len=32, dtype=getattr(jnp, cache_dtype))
    tc, hc = P.port_cache(jc), P.port_cache(jc)
    for off in (0, 8, 16, None):
        slot, take = (1, min(C, 21 - off)) if off is not None else (B, 0)
        off = off or 0
        toks = np.zeros(C, np.int64)
        toks[:take] = prefix[off:off + take]
        before = _snap(tc)
        d = lambda v: torch.tensor(v, dtype=torch.int64)
        tm.prefill_chunk(tp, tc, torch.from_numpy(toks), d(slot), d(off), d(take))
        _host_chunk(tp, tm.cfg, tm.policy, hc, torch.from_numpy(toks), slot, off, take)
        jc2 = jm.prefill_chunk(jp, jc, jnp.asarray(toks, jnp.int32), jnp.int32(slot),
                               jnp.int32(off), jnp.int32(take))
        for f in ("k", "v", "length"):
            assert torch.equal(getattr(tc, f), getattr(hc, f)), (off, f)
            np.testing.assert_allclose(P.to_np(getattr(tc, f)), P.to_np(getattr(jc2, f)),
                                       rtol=0, atol=1e-4, err_msg=f"{off} {f}")
            if slot == B:
                assert torch.equal(getattr(tc, f), getattr(before, f)), f
                np.testing.assert_array_equal(np.asarray(getattr(jc2, f), np.float32),
                                              np.asarray(getattr(jc, f), np.float32))
        jc = jc2
    assert tc.length.tolist() == [0, 21, 0]


def test_masked_slot_reset_resets_only_where_masked():
    """``cache_reset_slot`` with device indices and a mask: the masked
    slots rewind, the others keep every byte."""
    rng = np.random.default_rng(3)
    cfg = P.models("float32", "axq8")[2].cfg
    _, c = _random_cache(rng, cfg, 4, 8, "int8")
    before = _snap(c)
    cache_reset_slot(c, torch.tensor([2, 0]), mask=torch.tensor([True, False]))
    for f in c._fields:
        a, b = getattr(c, f), getattr(before, f)
        ax = 0 if f == "length" else 1
        assert not a.select(ax, 2).any(), f
        for s in (0, 1, 3):
            assert torch.equal(a.select(ax, s), b.select(ax, s)), (f, s)


# ---------------------------------------------------------------------------
# the capture-ready calls read nothing on the host
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every way a tensor's value reaches the host raises."""
    with monkeypatch.context() as m:
        for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
            def refuse(self, *a, _name=name, **k):
                raise AssertionError(f"host read: Tensor.{_name}")
            m.setattr(torch.Tensor, name, refuse)
        yield


def _qos():
    return QoSController(ladder=[{"ebits": e} for e in (8, 6)], low_water=0.25,
                         high_water=0.75, cooldown_steps=2)


@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
def test_capture_ready_lm_calls_read_nothing_on_the_host(kind, monkeypatch):
    """The step, each bucket's prefill and the chunk — what a capturing
    engine replays — run with every tensor-to-host conversion refused, and
    still do their work (lengths advance, prompts land)."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if kind == "int8" else "0")
    arch = DANUBE if kind == "ring" else P.ARCH
    _, _, m, params = P.models("bfloat16", "axq8", arch=arch)
    eng = ServeEngine(m, params, slots=3, max_len=32, qos=_qos(), emitter=False,
                      admission=AdmissionConfig(pack=2, chunk_tokens=8))
    wl, cache = eng.workload, eng.cache
    B = 3
    batch = wl._batch_inputs(2, 16, B)
    batch["tokens"][0, :11] = np.arange(1, 12)
    batch["slots"][0], batch["lengths"][0] = 1, 11
    chunk = wl._chunk_inputs(8, 2)
    chunk["tokens"][:] = np.arange(3, 11)
    chunk["clen"][...] = 8
    feed = torch.full((B, 1), 5, dtype=torch.int64)
    active = torch.tensor([False, True, True])
    with _no_host_reads(monkeypatch):
        wl._prefill_batch(eng.params, cache, batch, eng._degree)
        if wl._chunk_ok:
            wl._prefill_chunk(eng.params, cache, chunk, eng._degree)
        nxt, out = wl.step(eng.params, cache, feed, active, eng._gen, eng._degree)
    assert all(a is b for a, b in zip(out, cache))
    assert tuple(nxt.shape) == (B,) and nxt.dtype == torch.int32
    want = [0, 12, 9 if wl._chunk_ok else 1]
    assert cache.length.tolist() == want


def test_capture_ready_stream_step_reads_nothing_on_the_host(monkeypatch):
    ad = tstream.StreamAdapter(device="cpu")
    params = ad.init_params()
    state = ad.init_state(batch=3)
    feed = torch.from_numpy(tstream.make_clip(3, ad.cfg.frame, q=ad.cfg.q)).to(torch.int32)
    deg = torch.tensor([8, 6, 5], dtype=torch.int32)
    active = torch.tensor([True, False, True])
    with _no_host_reads(monkeypatch):
        out, new = ad.step(params, state, feed, active, None, deg)
    assert all(a is b for a, b in zip(new, state)) and state.length.tolist() == [1, 0, 1]
    assert tuple(out.shape) == (3, ad.cfg.frame)


@pytest.mark.parametrize("workload", ["lm", "stream"])
def test_engine_state_keeps_its_addresses(workload):
    """Serving advances the engine's state in place: every field keeps its
    tensor and device address across admission, steps and slot reuse (what
    a graph captured at construction reads)."""
    if workload == "lm":
        _, _, m, params = P.models("bfloat16", "axq8")
        eng = ServeEngine(m, params, slots=2, max_len=48, qos=_qos(), emitter=False,
                          admission=AdmissionConfig(pack=2, chunk_tokens=8))
        payloads = [np.arange(1, n + 1) for n in (5, 30, 9, 3)]
    else:
        eng = tstream.StreamServeEngine(slots=2, device="cpu")
        payloads = [tstream.make_clip(n, eng.workload.cfg.frame, seed=n) for n in (2, 4, 3)]
    ptrs = [t.data_ptr() for t in eng.state]
    fields = list(eng.state)
    reqs = [eng.submit(p, 4) if workload == "lm" else eng.submit(p) for p in payloads]
    eng.run_until_drained()
    assert all(r.done for r in reqs)
    assert [t.data_ptr() for t in eng.state] == ptrs
    assert all(a is b for a, b in zip(eng.state, fields))


# ---------------------------------------------------------------------------
# the switch and the graph set's bookkeeping
# ---------------------------------------------------------------------------


def test_capture_switch_on_the_cpu():
    _, _, m, params = P.models("bfloat16", "axq8")
    with pytest.raises(ValueError, match="CUDA"):
        ServeEngine(m, params, slots=2, max_len=32, capture=True)
    with pytest.raises(ValueError, match="CUDA"):
        tstream.StreamServeEngine(slots=2, device="cpu", capture=True)
    for capture in (None, False):
        eng = ServeEngine(m, params, slots=2, max_len=32, capture=capture)
        assert eng.capture is False and eng.graphs is None and eng.workload.graphs is None


class _StubGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


class _StubEvent:
    def record(self):
        pass

    def synchronize(self):
        pass


class _StubSet(tgraphs.GraphSet):
    """The graph set's bookkeeping with the device side stubbed: warming
    runs the callable, a capture runs it once (as a capture records the
    wrappers' Python), a replay runs no Python."""

    reserved = 0

    def _new_pool(self):
        return "pool"

    def _side_stream(self):
        return None

    def _pinned(self, like):
        return torch.empty_like(like)

    def _event(self):
        return _StubEvent()

    def pool_bytes(self):
        return self.reserved

    def _warm(self, fn, inputs):
        fn(**inputs)

    def _capture(self, fn, inputs):
        self.reserved += 4096
        return _StubGraph(), fn(**inputs)


def test_graph_set_launch_bookkeeping_with_a_stub_graph():
    saved = [dict(d) for d in tgraphs._counters()]
    try:
        _build.reset_counts()

        def call(x, n):
            _build.launches["axqmm"] += 3
            _build.launches["flash_attention"] += 1
            _build.flash_schedules["tri"] += 1
            return x * n

        gs = _StubSet("cpu")
        inputs = {"x": torch.zeros(4), "n": torch.ones((), dtype=torch.int64)}
        c = gs.capture(("step", (4,)), call, inputs)
        # the warm-up ran (and counted); the capture ran nothing
        assert _build.launches["axqmm"] == 3 and _build.flash_schedules["tri"] == 1
        assert c.delta == [{"axqmm": 3, "flash_attention": 1}, {"tri": 1}, {}]
        assert c.pool_bytes == 4096 and c.capture_s >= 0 and ("step", (4,)) in gs
        out = gs.run(("step", (4,)), {"x": np.arange(4.0), "n": np.asarray(2)})
        gs.replay(("step", (4,)))
        assert torch.equal(c.inputs["x"], torch.arange(4.0)) and int(c.inputs["n"]) == 2
        assert out is c.out and c.graph.replays == 2 and c.replays == 2
        assert _build.launches["axqmm"] == 3 + 2 * 3
        assert _build.launches["flash_attention"] == 1 + 2
        assert _build.flash_schedules["tri"] == 1 + 2
        s = gs.summary()
        assert s["graphs"] == 1 and s["pool_bytes"] == 4096
        assert s["shapes"][repr(("step", (4,)))]["replays"] == 2
        with pytest.raises(ValueError, match="already captured"):
            gs.capture(("step", (4,)), call, inputs)

        def broken(x, n):
            raise RuntimeError("operation not permitted when stream is capturing")

        gs._warm = lambda fn, inputs: None
        with pytest.raises(RuntimeError, match=r"prefill_batch.*\(2, 16\)"):
            gs.capture(("prefill_batch", (2, 16)), broken, inputs)
        assert ("prefill_batch", (2, 16)) not in gs
    finally:
        for d, s in zip(tgraphs._counters(), saved):
            d.update(s)
