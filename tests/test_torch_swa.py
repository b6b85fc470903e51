"""Port parity of the sliding-window path (h2o-danube-1.8b): the ``band``
schedule of the prefill attention kernel, the window mask, the ring KV
cache past the window (f32 and int8), and the engine on a window arch,
against the JAX package.

Reference: the JAX Pallas route in interpret mode (``flash_attention``
with its banded grid; ``_torch_parity.jax_backend("pallas")`` for the
model and the engine), whose kernels the port's plain versions mirror.

Tolerances: attention rtol 1e-5 / atol 1e-4 in f32 (the flash-attention
tolerance of tests/test_torch_kernels.py); ``band`` against ``dense`` with
the same window bit for bit (a fully masked block leaves the online-softmax
state untouched); the model's logits and f32 cache rows atol 1e-4 in f32
(tests/test_torch_models.py); the int8 cache's codes bit for bit and its
scales to rtol 1e-6 (tests/test_torch_kvq.py); the engine's greedy streams
equal up to near-ties below LOGIT_TOL (tests/test_torch_serve.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.dynamic import QoSController as JQoS
from repro.kernels import dispatch as jdispatch
from repro.kernels import flash_attention as jfa
from repro.models import cache_ops as jcache_ops
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import cache_ops as tcache_ops
from repro_torch.models import attention as tattn
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4
ATOL_LOGITS = 1e-4
RTOL_SCALES = 1e-6
LOGIT_TOL = 1e-2
ARCH = "h2o-danube-1.8b-smoke"        # swa_window 32: a ring of T = 32


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the band schedule: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", [1, 40, 64])
@pytest.mark.parametrize("D", [16, 80])
@pytest.mark.parametrize("S", [256, 250])
def test_band_plain_matches_pallas_with_steps(S, D, window):
    """32-token blocks (8 of them; 250 leaves a ragged last block): the
    plain ``band`` within the flash-attention tolerance of the Pallas
    kernel, the same block-step count as the reference's in-kernel counter
    and ``planned_grid_steps``, and bit for bit the plain ``dense`` run
    under the same window."""
    rng = np.random.default_rng(S + D + window)
    BH = 2
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=True, window=window, bq=32, bk=32,
                                 interpret=True, return_steps=True)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                                 bq=32, bk=32, return_steps=True)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    planned = tfa.planned_grid_steps(BH, S, window=window, bq=32, bk=32)
    assert int(st) == int(sj) == planned
    assert planned == jfa.planned_grid_steps(BH, S, window=window, bq=32, bk=32)
    assert planned < tfa.planned_grid_steps(BH, S, bq=32, bk=32)     # fewer than tri
    od, sd = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window,
                                 bq=32, bk=32, skip_grid=False, return_steps=True)
    assert sd == BH * 8 * 8
    assert torch.equal(ot, od)


def test_window_covering_the_sequence_runs_tri():
    """A window at least the sequence length is plain causal attention: the
    ``tri`` schedule and its step count, bit for bit."""
    rng = np.random.default_rng(1)
    q = _t(rng.standard_normal((2, 40, 16)).astype(np.float32))
    ow, sw = tfa.flash_attention(q, q.flip(1), q, causal=True, window=40,
                                 return_steps=True)
    oc, sc = tfa.flash_attention(q, q.flip(1), q, causal=True, return_steps=True)
    assert sw == sc == tfa.planned_grid_steps(2, 40)
    assert torch.equal(ow, oc)


def test_grouped_window_entry_matches_flat():
    """The model-layout entry with a window equals the (BH, S, D) entry on
    K/V repeated to every head."""
    rng = np.random.default_rng(7)
    B, S, H, KVr, D = 2, 300, 4, 2, 80
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True, window=100)
    flat = lambda t: t.transpose(1, 2).reshape(B * H, S, D)
    of = tfa.flash_attention(flat(q), flat(tattn.repeat_kv(k, H)),
                             flat(tattn.repeat_kv(v, H)), causal=True, window=100)
    assert torch.equal(flat(og), of)


def test_prefill_dispatch_window_matches_reference():
    """``dispatch.prefill_attention`` with a window shorter than the
    sequence (the plain ``band`` on the CPU) against the reference's router
    on its Pallas route."""
    rng = np.random.default_rng(3)
    B, S, H, KVr, D, W = 2, 300, 4, 2, 80, 100
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVr, D)).astype(np.float32)
    with P.jax_backend("pallas"):
        oj = jdispatch.prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True, window=W)
    ot = tdispatch.prefill_attention(_t(q), _t(k), _t(v), causal=True, window=W)
    assert tdispatch.last_route["prefill"] == "torch"
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    # the reference's blockwise jnp oracle agrees as well
    oa = tattn.attn_blockwise(_t(q), _t(k), _t(v), causal=True, window=W)
    np.testing.assert_allclose(ot.numpy(), oa.numpy(), rtol=RTOL, atol=ATOL)


def test_window_below_one_token_raises():
    """A window of no token masks every column, which the kernel's
    ``window = 0`` (no window) would not: the wrapper refuses it."""
    q = torch.zeros(1, 40, 16)
    with pytest.raises(ValueError):
        tfa.flash_attention(q, q, q, causal=True, window=0)


# ---------------------------------------------------------------------------
# the ring KV cache past the window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("P_len", [1, 31, 32, 33, 67, 400])
def test_ring_write_indices_match_reference(P_len):
    """The last min(P, T) tokens at ring position j % T, at P = T, T + 1
    and 2T + 3 among others (an off-by-one here passes every short-prompt
    test)."""
    T = 32
    js, jd = jcache_ops.ring_write_indices(P_len, T)
    ts, td = tcache_ops.ring_write_indices(P_len, T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert ts.tolist() == list(range(max(P_len - T, 0), P_len))


_JITS: dict = {}


def _jitted(jm):
    if id(jm) not in _JITS:
        _JITS[id(jm)] = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return _JITS[id(jm)]


def _check_cache(jc, tc, quant, where):
    for f in (("k", "v", "ks", "vs") if quant else ("k", "v")):
        ref, port = P.to_np(getattr(jc, f)), P.to_np(getattr(tc, f))
        msg = f"{where}: {f}"
        if f in ("ks", "vs"):
            np.testing.assert_allclose(port, ref, rtol=RTOL_SCALES, atol=0, err_msg=msg)
        elif quant:
            np.testing.assert_array_equal(port, ref, err_msg=msg)
        else:
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=msg)
    assert P.to_np(tc.length).tolist() == P.to_np(jc.length).tolist(), where


def _ring_prefill_decode(P_len, steps, *, quant=False, degree=6, **overrides):
    """Prefill a ``P_len``-token prompt into slot 1 of a 2-slot ring cache
    (max_len 64, so T = window = 32), then ``steps`` decode steps with
    slot 0 free (the write slot wraps the ring), in both packages: logits
    and cache after each call.  The float cache is f32 here: a bf16 cache
    rounds K/V values that the packages compute an f32 ulp apart to
    neighbouring bf16 values now and then (3 of 20,480 cached values at
    head_dim 80, by 2**-10), which says nothing of the ring's indexing."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=ARCH, **overrides)
    prefill_j, decode_j = _jitted(jm)
    jdeg, tdeg = P.degrees(degree)
    rng = np.random.default_rng(P_len)
    prompt = rng.integers(0, 512, P_len).astype(np.int32)
    active = np.array([False, True])
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=2, max_len=64, dtype=jnp.float32, quant=quant)
        tc = P.port_cache(jc)
        assert tc.k.shape[2] == 32 and (quant or tc.k.dtype == torch.float32)
        lj, jc = prefill_j(jp, jc, jnp.asarray(prompt), jnp.int32(1), degree=jdeg)
        lt, tc = tm.prefill(tp, tc, torch.from_numpy(prompt), 1, degree=tdeg)
        np.testing.assert_allclose(P.to_np(lt), P.to_np(lj), rtol=0, atol=ATOL_LOGITS,
                                   err_msg="prefill logits")
        _check_cache(jc, tc, quant, "prefill")
        for t in range(steps):
            toks = rng.integers(0, 512, (2, 1)).astype(np.int32)
            lj, jc = decode_j(jp, jc, jnp.asarray(toks), degree=jdeg,
                              active=jnp.asarray(active))
            lt, tc = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                    degree=tdeg, active=torch.from_numpy(active))
            np.testing.assert_allclose(P.to_np(lt)[1], P.to_np(lj)[1], rtol=0,
                                       atol=ATOL_LOGITS, err_msg=f"decode {t} logits")
            # the engine pins free slots' length; here both advance alike
            _check_cache(jc, tc, quant, f"decode {t}")
    return tc


@pytest.mark.parametrize("P_len", [32, 33, 67])
def test_ring_prefill_boundaries_match_reference(P_len):
    """Prompts of exactly T, T + 1 and 2T + 3 tokens on the ring, then two
    decode steps."""
    tc = _ring_prefill_decode(P_len, 2)
    assert int(tc.length[1]) == P_len + 2


@pytest.mark.parametrize("quant,overrides", [(False, {}), (False, {"head_dim": 80}),
                                             (True, {})],
                         ids=["f32-cache", "head-dim-80", "int8-cache"])
def test_lm_prefill_past_window_and_decode_match_reference(quant, overrides):
    """A 400-token prompt (12.5 windows; ``band`` at prefill) and 8 decode
    steps across the ring's wrap, f32 under axq8: logits within 1e-4; the
    f32 cache's rows within 1e-4, the int8 cache's codes bit for bit and
    its scales to rtol 1e-6."""
    degree = (8, 6, 7) if quant else 6
    tc = _ring_prefill_decode(400, 8, quant=quant, degree=degree, **overrides)
    assert int(tc.length[1]) == 408


# ---------------------------------------------------------------------------
# the engine on a window arch
# ---------------------------------------------------------------------------


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25,
                high_water=0.75, cooldown_steps=2)


def test_engine_window_arch_streams_match_reference():
    """Five requests on two slots with bucketed, packed admission (max_len
    32: buckets 16 and 32), two of them longer than the window and the
    largest bucket, which fall back to exact-length admission (``band``):
    the port's greedy streams equal the JAX engine's on its Pallas route."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=ARCH)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (40, 5, 70, 20, 9)]
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=JAdmissionConfig(pack=2), emitter=False)
        jreqs = [jeng.submit(p, 6) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=AdmissionConfig(pack=2), emitter=False)
    wl = teng.workload
    assert wl._max_prompt is None and not tm.supports_chunked_prefill()
    assert wl.admission.buckets == (16, 32)
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg, (tdeg, jdeg)
    # the two long prompts took the exact path, one call shape each
    assert wl.trace_counts["prefill"] == 2
    assert wl.trace_counts == {k: jeng.workload.trace_counts[k] for k in wl.trace_counts}
    print(f"near-ties compared by logits instead of tokens: {near_ties}")
