"""Port parity of the admission pipeline: bucketed, packed and chunked
prefill, warmup and the call-shape contract, the background emitter, and
the serving engine on the int8 KV cache against the JAX engine.

Bit-identity claims held here on the CPU with the plain versions, at fixed
seeds (``parametrize`` cases, not random draws): a prompt padded to its
bucket writes the same cache bytes as at its exact length, and decodes the
same next logits; dummy pack rows write nothing; packed admission gives the
same token streams as one prompt per call.  Against the reference: the
bucket ladder equals the reference's; chunked prefill in f32 within 1e-4
(its attention is plain PyTorch in the port, jnp in the reference); the
engine's greedy streams with ``pack=2`` on the int8 cache equal the JAX
engine's on its degree-aware Pallas route, up to near-ties (LOGIT_TOL,
as in test_torch_serve.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.dynamic import QoSController as JQoS
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.admission import bucket_ladder as jbucket_ladder
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import LMCache, LMCacheQ
from repro_torch.serve.admission import AdmissionConfig, bucket_for, bucket_ladder
from repro_torch.serve.emitq import AsyncEmitter, default_detok
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

LOGIT_TOL = 1e-2


def _model(dtype="bfloat16"):
    """(port model, port params) of the smoke arch under axq8, prepacked."""
    _, _, tm, tp = P.models(dtype, "axq8")
    return tm, tp


def _prompts(n, lens=None, seed=0, vocab=512):
    rng = np.random.default_rng(seed)
    if lens is None:
        lens = rng.integers(2, 30, n)
    return [rng.integers(1, vocab, int(ln)) for ln in lens]


def _assert_cache_equal(a, b, msg=""):
    assert type(a) is type(b)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), f"{msg}: cache.{name}"


def _snapshot(cache):
    return type(cache)(*(t.clone() for t in cache))


# ---------------------------------------------------------------------------
# config primitives: the port's copy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_len", [1, 2, 8, 17, 18, 48, 64, 100, 512, 1024])
def test_bucket_ladder_matches_reference(max_len):
    assert bucket_ladder(max_len) == jbucket_ladder(max_len)
    a = AdmissionConfig(pack=3, chunk_tokens=8).resolved(max_len)
    j = JAdmissionConfig(pack=3, chunk_tokens=8).resolved(max_len)
    assert (a.buckets, a.pack, a.chunk_tokens) == (j.buckets, j.pack, j.chunk_tokens)


def test_bucket_for_and_config_validation():
    buckets = (16, 32, 64)
    assert [bucket_for(n, buckets) for n in (1, 16, 17, 64)] == [16, 16, 32, 64]
    with pytest.raises(ValueError):
        bucket_for(65, buckets)
    for bad in (dict(pack=0), dict(chunk_tokens=-1), dict(buckets=(32, 16))):
        with pytest.raises(ValueError):
            AdmissionConfig(**bad)
    assert AdmissionConfig(buckets=(8, 24)).resolved(64).buckets == (8, 24)


# ---------------------------------------------------------------------------
# bucketed prefill: padded == exact, dummy rows write nothing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("seed,Pb", [(0, 16), (1, 64), (2, 64), (3, 256)])
def test_padded_bucket_prefill_bit_identical(seed, Pb, quant, dtype):
    """Three prompts prefilled one by one at their exact lengths, and the
    same three padded to one bucket in one call: the same cache bytes, and
    the same logits from the next decode step."""
    m, params = _model(dtype)
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, Pb + 1, 3)
    rows = [rng.integers(1, 512, int(n)) for n in lens]
    slots, max_len = 4, 256
    exact = m.init_cache(1, slots, max_len, quant=quant)
    for i, row in enumerate(rows):
        m.prefill(params, exact, torch.from_numpy(row), i)
    toks = np.zeros((3, Pb), np.int64)
    for i, row in enumerate(rows):
        toks[i, :row.size] = row
    padded = m.prefill_batch(params, m.init_cache(1, slots, max_len, quant=quant),
                             torch.from_numpy(toks), [0, 1, 2], lens)
    _assert_cache_equal(exact, padded, f"seed={seed}")
    nxt = torch.from_numpy(rng.integers(1, 512, (slots, 1)))
    le, _ = m.decode_step(params, exact, nxt)
    lp, _ = m.decode_step(params, padded, nxt)
    assert torch.equal(le, lp)


@pytest.mark.parametrize("quant", [False, True])
def test_dummy_pack_rows_leave_cache_untouched(quant):
    """Dummy rows (slot = B) never write: two calls whose dummy rows carry
    different garbage give the same cache, and an all-dummy call leaves a
    live cache as it was, byte for byte."""
    m, params = _model()
    rng = np.random.default_rng(11)
    Pb, B = 16, 3
    row = rng.integers(1, 512, 7)
    caches = []
    for _ in range(2):
        toks = np.zeros((3, Pb), np.int64)
        toks[0, :7] = row
        toks[1:] = rng.integers(1, 512, (2, Pb))
        caches.append(m.prefill_batch(params, m.init_cache(1, B, 32, quant=quant),
                                      torch.from_numpy(toks), [1, B, B], [7, 0, 0]))
    _assert_cache_equal(caches[0], caches[1])
    before = _snapshot(caches[0])
    m.prefill_batch(params, caches[0], torch.from_numpy(rng.integers(1, 512, (3, Pb))),
                    [B, B, B], [5, 9, 16])
    _assert_cache_equal(before, caches[0])


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_packed_admission_bit_identical_to_sequential(seed, quant, monkeypatch):
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    m, params = _model()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, 512, int(rng.integers(2, 30))) for _ in range(6)]
    outs = {}
    for pack in (1, 3):
        eng = ServeEngine(m, params, slots=4, max_len=64, seed=13, emitter=False,
                          admission=AdmissionConfig(pack=pack, warmup=False))
        assert isinstance(eng.cache, LMCacheQ if quant else LMCache)
        reqs = [eng.submit(p, 4) for p in prompts]
        eng.run_until_drained()
        outs[pack] = [r.out for r in reqs]
    assert outs[1] == outs[3]


# ---------------------------------------------------------------------------
# the engine on the int8 cache against the JAX engine
# ---------------------------------------------------------------------------


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25,
                high_water=0.75, cooldown_steps=2)


def test_engine_int8_cache_packed_streams_match_reference(monkeypatch):
    """Five requests on two slots, pack=2, int8 cache, QoS ladder 8 -> 6
    (the degree reaches the decode kernel's dequantization): the port's
    greedy streams equal the JAX engine's on its Pallas route."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    jm, jp, tm, tp = P.models("float32", "axq8")
    prompts = _prompts(5, lens=(5, 9, 20, 3, 12), seed=9)
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=JAdmissionConfig(pack=2), emitter=False)
        jreqs = [jeng.submit(p.astype(np.int32), 6) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=AdmissionConfig(pack=2), emitter=False)
    assert isinstance(teng.cache, LMCacheQ)
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg and {(8,), (6,)} <= set(tdeg), (tdeg, jdeg)
    assert int(teng.stats.c_packed_rows.value) == int(jeng.stats.c_packed_rows.value) > 0
    assert teng.workload.trace_counts == {k: jeng.workload.trace_counts[k]
                                          for k in teng.workload.trace_counts}
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


# ---------------------------------------------------------------------------
# warmup and the call-shape contract
# ---------------------------------------------------------------------------


def test_warmup_runs_every_shape_and_serving_adds_none():
    """Warmup runs each bucket, the chunk and the step shape once; serving
    20 mixed-length prompts afterwards meets no new shape."""
    m, params = _model()
    eng = ServeEngine(m, params, slots=4, max_len=64, seed=3,
                      admission=AdmissionConfig(pack=2, chunk_tokens=16))
    wl = eng.workload
    assert wl.trace_counts == {"prefill": 0, "prefill_batch": len(wl.admission.buckets),
                               "prefill_chunk": 1, "step": 1}
    assert int(eng.stats.c_warmups.value) == 1
    before = dict(wl.trace_counts)
    for p in _prompts(20, lens=np.random.default_rng(7).integers(2, 60, 20)):
        eng.submit(p, 3)
    eng.run_until_drained()
    assert wl.trace_counts == before, "a request met a new call shape"
    assert len(eng.done) == 20


def test_shape_count_bounded_by_bucket_ladder():
    """Without warmup, 20 random prompt lengths meet at most one prefill
    shape per bucket."""
    m, params = _model()
    eng = ServeEngine(m, params, slots=4, max_len=64, seed=3,
                      admission=AdmissionConfig(pack=2, warmup=False))
    wl = eng.workload
    assert wl.trace_counts["prefill_batch"] == 0
    for p in _prompts(20, lens=np.random.default_rng(9).integers(2, 60, 20)):
        eng.submit(p, 2)
    eng.run_until_drained()
    assert 1 <= wl.trace_counts["prefill_batch"] <= len(wl.admission.buckets)
    assert wl.trace_counts["step"] == 1


@pytest.mark.parametrize("quant", [False, True])
def test_warmup_leaves_live_state_untouched(quant, monkeypatch):
    """The warmup pass leaves a live cache (slots mid-request) as it was,
    byte for byte, and a warmed engine serves the same tokens as an
    exact-length one."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    m, params = _model()
    prompts = _prompts(6, seed=4)
    eng = ServeEngine(m, params, slots=3, max_len=64, seed=11, emitter=False,
                      admission=AdmissionConfig(pack=2, chunk_tokens=16, warmup=False))
    for p in prompts[:3]:
        eng.submit(p, 8)
    for _ in range(3):
        eng.tick()
    before = _snapshot(eng.cache)
    feed = eng._feed.copy()
    eng._warmup()
    _assert_cache_equal(before, eng.cache)
    assert (eng._feed == feed).all()
    legacy = ServeEngine(m, params, slots=3, max_len=64, seed=11)
    r0 = [legacy.submit(p, 5) for p in prompts]
    legacy.run_until_drained()
    warmed = ServeEngine(m, params, slots=3, max_len=64, seed=11,
                         admission=AdmissionConfig(pack=2, chunk_tokens=16))
    r1 = [warmed.submit(p, 5) for p in prompts]
    warmed.run_until_drained()
    assert [r.out for r in r1] == [r.out for r in r0]


def test_oversize_prompt_falls_back_to_exact_path():
    m, params = _model()
    eng = ServeEngine(m, params, slots=2, max_len=64, seed=5,
                      admission=AdmissionConfig(buckets=(8,)))
    long_p, short_p = _prompts(1, lens=[20], seed=6)[0], _prompts(1, lens=[5], seed=7)[0]
    r_long, r_short = eng.submit(long_p, 4), eng.submit(short_p, 4)
    eng.run_until_drained()
    assert eng.workload.trace_counts["prefill"] == 1
    ref = ServeEngine(m, params, slots=2, max_len=64, seed=5)
    q_long, q_short = ref.submit(long_p, 4), ref.submit(short_p, 4)
    ref.run_until_drained()
    assert r_long.out == q_long.out and r_short.out == q_short.out


def test_bucket_metrics_exported():
    m, params = _model()
    eng = ServeEngine(m, params, slots=4, max_len=64, seed=0,
                      admission=AdmissionConfig(pack=2))
    for p in _prompts(4, lens=[3, 5, 20, 25], seed=8):
        eng.submit(p, 2)
    eng.run_until_drained()
    assert int(eng.stats.c_packed_rows.value) == 4
    by_bucket = {k: int(c.value) for k, c in eng.stats.c_admit_bucket.children.items()}
    assert by_bucket == {("16",): 1, ("32",): 1}


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------


def test_prefill_chunk_matches_reference():
    """Two chunks of a 20-token prefix (8 + 8, then a 4-token tail in an
    8-token call) into slot 1 of an f32 cache, then one decode step, against
    the reference's ``lm_prefill_chunk``."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, 512, 20)
    jdeg, tdeg = P.degrees(6)
    jc = jm.init_cache(tp=1, batch=2, max_len=32, dtype=jnp.float32)
    tc = P.port_cache(jc)
    chunk_j = jax.jit(jm.prefill_chunk)
    for off in (0, 8, 16):
        take = min(8, 20 - off)
        toks = np.zeros(8, np.int64)
        toks[:take] = prefix[off:off + take]
        jc = chunk_j(jp, jc, jnp.asarray(toks, jnp.int32), jnp.int32(1), jnp.int32(off),
                     jnp.int32(take), degree=jdeg)
        tc = tm.prefill_chunk(tp, tc, torch.from_numpy(toks), 1, off, take, degree=tdeg)
    assert tc.length.tolist() == [0, 20]
    for f in ("k", "v"):
        np.testing.assert_allclose(P.to_np(getattr(tc, f)), P.to_np(getattr(jc, f)),
                                   rtol=0, atol=1e-4, err_msg=f)
    nxt = rng.integers(1, 512, (2, 1))
    lj, _ = jax.jit(jm.decode_step)(jp, jc, jnp.asarray(nxt, jnp.int32), degree=jdeg)
    lt, _ = tm.decode_step(tp, tc, torch.from_numpy(nxt), degree=tdeg)
    np.testing.assert_allclose(P.to_np(lt)[1], P.to_np(lj)[1], rtol=0, atol=1e-4)


def test_chunked_prefill_interleaves_with_decode():
    """While a long prompt admits chunk by chunk, a co-resident short
    request keeps decoding."""
    m, params = _model()
    eng = ServeEngine(m, params, slots=2, max_len=64, seed=2,
                      admission=AdmissionConfig(pack=1, chunk_tokens=8,
                                                chunk_calls_per_tick=1))
    short = eng.submit(_prompts(1, lens=[3], seed=1)[0], 8)
    long_r = eng.submit(_prompts(1, lens=[50], seed=2)[0], 4)
    progressed = False
    for _ in range(5):
        eng.tick()
        if short.out and not eng.workload.admit_complete(long_r):
            progressed = True
    assert progressed, "short request starved behind chunked admission"
    eng.run_until_drained()
    assert len(short.out) == 8 and len(long_r.out) == 4
    assert int(eng.stats.c_chunk_calls.value) == 7       # ceil(49 / 8)


def test_chunk_calls_per_tick_budget():
    m, params = _model()
    eng = ServeEngine(m, params, slots=1, max_len=64, seed=2,
                      admission=AdmissionConfig(chunk_tokens=8, chunk_calls_per_tick=2))
    req = eng.submit(_prompts(1, lens=[40], seed=3)[0], 2)
    eng.tick()                     # the first chunk rides the admit tick
    assert req.cursor == 8
    eng.tick()                     # then 2 chunk calls per tick
    assert req.cursor == 24
    eng.run_until_drained()
    assert len(req.out) == 2


def test_admission_only_tick_runs_no_step():
    m, params = _model()
    eng = ServeEngine(m, params, slots=1, max_len=64, seed=2,
                      admission=AdmissionConfig(chunk_tokens=8))
    eng.submit(_prompts(1, lens=[30], seed=4)[0], 2)
    steps0 = int(eng.stats.c_steps.value)
    assert eng.tick() == 1                    # slot held, nothing decodable
    assert int(eng.stats.c_steps.value) == steps0


def test_chunking_is_off_under_int8_cache(monkeypatch):
    """The int8 cache admits long prompts whole through the buckets (as
    the reference gates it): no chunk call, no chunk shape."""
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    m, params = _model()
    eng = ServeEngine(m, params, slots=2, max_len=64, seed=2,
                      admission=AdmissionConfig(pack=2, chunk_tokens=8))
    assert isinstance(eng.cache, LMCacheQ)
    req = eng.submit(_prompts(1, lens=[40], seed=5)[0], 3)
    eng.run_until_drained()
    assert len(req.out) == 3
    assert int(eng.stats.c_chunk_calls.value) == 0
    assert eng.workload.trace_counts["prefill_chunk"] == 0
    with pytest.raises(ValueError):
        m.prefill_chunk(params, eng.cache, torch.zeros(8, dtype=torch.int64), 0, 0, 8)


# ---------------------------------------------------------------------------
# background emitter
# ---------------------------------------------------------------------------


class _Req:
    pass


def test_async_emitter_order_and_flush():
    got = []
    em = AsyncEmitter(on_emit=lambda req, piece: got.append(piece))
    r = _Req()
    for i in range(50):
        em.push(r, i)
    assert em.flush(timeout=5.0)
    assert r.detok == [f"<{i}>" for i in range(50)]
    assert got == r.detok
    assert em.emitted == 50 and em.errors == 0
    em.close()
    with pytest.raises(RuntimeError):
        em.push(r, 0)
    em.close()                                        # idempotent


def test_async_emitter_survives_detok_errors():
    def bad(item):
        if int(item) == 2:
            raise RuntimeError("boom")
        return default_detok(item)

    em = AsyncEmitter(detok=bad)
    r = _Req()
    for i in range(4):
        em.push(r, i)
    assert em.flush(timeout=5.0)
    assert em.errors == 1 and em.emitted == 3
    assert r.detok == ["<0>", "<1>", "<3>"]
    em.close()


def test_engine_emits_in_background():
    m, params = _model()
    eng = ServeEngine(m, params, slots=2, max_len=64, seed=1,
                      admission=AdmissionConfig(pack=2))
    reqs = [eng.submit(p, 4) for p in _prompts(3, seed=5)]
    eng.run_until_drained()                 # the drain flushes the emitter
    for r in reqs:
        assert r.detok == [f"<{t}>" for t in r.out]
    assert eng.emitter.emitted == sum(len(r.out) for r in reqs)
    opt_out = ServeEngine(m, params, slots=2, max_len=64,
                          admission=AdmissionConfig(), emitter=False)
    assert opt_out.emitter is None
    req = opt_out.submit(_prompts(1, seed=6)[0], 3)
    opt_out.run_until_drained()
    assert not hasattr(req, "detok")


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------


def test_launcher_admission_flags(monkeypatch):
    ap = launch_serve.build_parser()
    assert launch_serve.admission_from_args(ap.parse_args([])) is None
    a = launch_serve.admission_from_args(ap.parse_args(
        ["--prefill-buckets", "8,16", "--pack", "4", "--chunk-tokens", "32"]))
    assert (a.buckets, a.pack, a.chunk_tokens) == ((8, 16), 4, 32)
    auto = launch_serve.admission_from_args(ap.parse_args(["--prefill-buckets", "auto"]))
    assert auto.buckets == () and auto.pack == 1
    monkeypatch.setenv("REPRO_KV_INT8", "1")
    s = launch_serve.main(["--device", "cpu", "--approx", "axq8", "--qos",
                           "--prefill-buckets", "auto", "--pack", "4", "--slots", "2",
                           "--requests", "5", "--new-tokens", "2", "--max-len", "64"])
    assert s["requests"] == 5 and s["generated_tokens"] == 10
