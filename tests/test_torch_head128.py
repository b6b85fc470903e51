"""Port parity at head_dim 128, the reference's own TPU head dim: the two
registered dense archs with D = 128, qwen2.5-3b (QKV bias, GQA 16/2) and
mistral-nemo-12b (GQA 32/8), at smoke size against the JAX package.

Reference: the JAX Pallas route in interpret mode (``flash_attention``,
``flash_decode``, ``flash_decode_quant``; ``_torch_parity.jax_backend
("pallas")`` for the models and engines), whose kernels the port's plain
versions mirror.  The smoke variants have head_dim 16, so D = 128 is a
config override on both sides.  The QKV biases are zeros at init in both
packages; the model tests fill them with the same seeded values first, so
that they reach the logits.

Tolerances: attention rtol 1e-5 / atol 1e-4 in f32 (tests/test_torch_
kernels.py), the int8-cache decode 1e-5 abs (tests/test_torch_kvq.py), the
models' logits and cache rows atol 1e-4 in f32 (tests/test_torch_models.py),
the engines' greedy streams equal up to near-ties below LOGIT_TOL (tests/
test_torch_serve.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.dynamic import QoSController as JQoS
from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels.qstore import PackedQWeight
from repro_torch.models.transformer import LMCacheQ
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-4
ATOL_QUANT = 1e-5
ATOL_LOGITS = 1e-4
LOGIT_TOL = 1e-2
QWEN, NEMO = "qwen2.5-3b-smoke", "mistral-nemo-12b-smoke"
D = 128


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# the plain kernels at D = 128 vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,window,blk", [
    ("tri", 200, None, 128), ("dense", 200, None, 128),
    ("tri", 250, None, 32), ("band", 250, 40, 32), ("band", 250, 100, 32)])
def test_plain_flash_attention_head128_matches_pallas_with_steps(kind, S, window, blk):
    """Each schedule at D = 128 (S = 200 pads past one 128-row block; 250
    leaves a ragged last 32-row block): within the f32 tolerance of the
    Pallas kernel, the same block-step count as its in-kernel counter and
    ``planned_grid_steps``; ``tri`` and ``band`` bit for bit the plain
    ``dense`` run under the same mask."""
    rng = np.random.default_rng(S + blk + (window or 0))
    BH = 2
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    skip = kind != "dense"
    kw = dict(causal=True, window=window, bq=blk, bk=blk, skip_grid=skip)
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 interpret=True, return_steps=True, **kw)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), return_steps=True, **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    planned = tfa.planned_grid_steps(BH, S, window=window, bq=blk, bk=blk, skip_grid=skip)
    assert int(st) == int(sj) == planned
    assert planned == jfa.planned_grid_steps(BH, S, window=window, bq=blk, bk=blk,
                                             skip_grid=skip)
    assert tfa._plan(S, True, window, blk, blk, skip)[0] == kind
    od = tfa.flash_attention(_t(q), _t(k), _t(v), causal=True, window=window, bq=blk,
                             bk=blk, skip_grid=False)
    assert torch.equal(ot, od)


def test_grouped_head128_entry_matches_flat():
    """The model-layout entry at qwen's grouping (16 heads over 2 kv heads)
    equals the (BH, S, D) entry on K/V repeated to every head."""
    rng = np.random.default_rng(16)
    B, S, H, KVr = 1, 150, 16, 2
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, S, KVr, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    of = tfa.flash_attention(flat(q), flat(k.repeat_interleave(H // KVr, 2)),
                             flat(v.repeat_interleave(H // KVr, 2)), causal=True)
    assert torch.equal(flat(og), of)


@pytest.mark.parametrize("KVr,G", [(2, 8), (8, 4)], ids=["qwen", "nemo"])
def test_plain_flash_decode_head128_matches_pallas(KVr, G):
    """The bf16/f32-cache decode at D = 128 with qwen's and mistral-nemo's
    grouping: mixed lengths past the reference's 128-row tile, a freed
    slot of exact zeros."""
    rng = np.random.default_rng(KVr * 10 + G)
    B, T = 4, 150
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    nvalid = np.array([1, 77, 150, 129], np.int32)
    active = np.array([1, 0, 1, 1], np.int32)
    oj = jfd.flash_decode(*map(jnp.asarray, (qg, k, v, nvalid, active)), interpret=True)
    ot = tfd.flash_decode(*map(_t, (qg, k, v, nvalid, active)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL, atol=ATOL)
    assert (ot[1] == 0).all()


@pytest.mark.parametrize("ebits", [8, 5])
@pytest.mark.parametrize("KVr,G", [(2, 8), (8, 4)], ids=["qwen", "nemo"])
def test_plain_flash_decode_quant_head128_matches_pallas(KVr, G, ebits):
    """The int8-cache decode at D = 128, degraded at ``ebits``, on a ragged
    T = 135 with one free slot."""
    rng = np.random.default_rng(ebits * 100 + KVr)
    B, T = 4, 135
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, T, KVr, D)).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, (B, T, KVr)).astype(np.float32)
    nvalid = np.array([1, T // 2 + 1, T, 7], np.int32)
    active = np.array([1, 1, 1, 0], np.int32)
    oj = jfd.flash_decode_quant(*map(jnp.asarray, (qg, k, ks, v, vs, nvalid, active)),
                                jnp.asarray([ebits], jnp.int32), interpret=True)
    ot = tfd.flash_decode_quant(*map(_t, (qg, k, ks, v, vs, nvalid, active)),
                                torch.tensor(ebits, dtype=torch.int32))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=ATOL_QUANT)
    assert (ot[3] == 0).all()


# ---------------------------------------------------------------------------
# the kernel wrapper: D = 128 launches, an unbuilt head dim raises
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrapper's launch path on ``meta`` tensors (no card here): the
    sm_90 check passes, the C entry point records its calls, and the plain
    versions raise if anything falls back to them."""
    calls = []

    def entry(fn):
        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(tfa, "flash_attention_plain", no_fallback)
    monkeypatch.setattr(tfa, "flash_attention_grouped_plain", no_fallback)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_128_launches_the_kernel(fake_card, dtype):
    """qwen's prefill shapes (16 heads over 2 kv heads, D = 128) reach the
    C launcher with D = 128 and the tri schedule; the views pass the
    16-byte rule at H * D = 2048 and KVr * D = 256."""
    before = dict(_build.launches)
    B, S, H, KVr = 2, 300, 16, 2
    out = tfa.flash_attention_grouped(_meta(B, S, H, D, dtype=dtype),
                                      _meta(B, S, KVr, D, dtype=dtype),
                                      _meta(B, S, KVr, D, dtype=dtype), causal=True)
    assert out.shape == (B, S, H, D)
    (fn, args), = fake_card
    assert fn == "flash_attention_launch"
    assert args[5:15] == (B, S, H, H // KVr, D, 128, 1, 1, 0, 0)
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    for t, name in ((_meta(B, S, H * D).view(B, S, H, D), "q"),
                    (_meta(B, S, KVr * D).view(B, S, KVr, D), "k")):
        assert tfa.tc_view_error(t, name) is None


@pytest.mark.parametrize("bad", [96, 512])
def test_unbuilt_head_dim_raises_without_fallback(fake_card, bad):
    """A head dim the kernel was not instantiated for raises before any
    launch, on every entry, and never runs the plain version instead."""
    before = dict(_build.launches)
    q = _meta(1, 40, 4, bad)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_grouped(q, _meta(1, 40, 2, bad), _meta(1, 40, 2, bad))
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention(_meta(4, 40, bad), _meta(4, 40, bad), _meta(4, 40, bad))
    assert fake_card == []
    assert _build.launches == before


# ---------------------------------------------------------------------------
# the QKV bias leaves through convert
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx", ["exact", "axq8"])
def test_qkv_bias_leaves_round_trip_through_convert(approx):
    """qwen's wq/wk/wv bias leaves (seeded, nonzero) come through
    ``params_from_numpy`` bit for bit beside their weights, packed or
    not; wo and the MLP carry no bias."""
    jm, jp, tm, tp = P.models("float32", approx, arch=QWEN, bias_seed=3, head_dim=D)
    for key in ("wq", "wk", "wv"):
        jb, tb = np.asarray(jp["layers"][key]["b"]), tp["layers"][key]["b"]
        assert tb.dtype == torch.float32 and tuple(tb.shape) == jb.shape
        np.testing.assert_array_equal(tb.numpy(), jb)
        assert np.abs(jb).max() > 0.1
        w = tp["layers"][key]["w"]
        assert isinstance(w, PackedQWeight) == (approx != "exact")
    assert "b" not in tp["layers"]["wo"] and "b" not in tp["layers"]["mlp"]["up"]
    again = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert torch.equal(again["layers"]["wk"]["b"], tp["layers"]["wk"]["b"])


# ---------------------------------------------------------------------------
# the models and the engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,head_dim,approx,degree", [
    (QWEN, 16, "exact", None), (QWEN, 16, "axq8", 6), (QWEN, 16, "axq8", "vector"),
    (QWEN, D, "exact", None), (QWEN, D, "axq8", 6), (QWEN, D, "axq8", "vector"),
    (NEMO, D, "exact", None), (NEMO, D, "axq8", 6)])
def test_prefill_decode_match_reference(arch, head_dim, approx, degree):
    """``lm_prefill`` then ``lm_decode_step`` in f32: logits and the live
    cache rows within 1e-4 of the Pallas route (qwen with its seeded QKV
    biases).  The cache is f32, as in tests/test_torch_swa.py: on a bf16
    cache a K/V value the packages compute an f32 ulp apart now and then
    rounds to neighbouring bf16 values (1 of 49,152 cached values at
    head_dim 128, by 2**-11), which says nothing of the model."""
    bias_seed = 3 if arch == QWEN else None
    prefill, decode = P.run_prefill_decode("float32", approx, degree, "pallas",
                                           cache_dtype=jnp.float32, arch=arch,
                                           bias_seed=bias_seed, head_dim=head_dim)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=name)


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25,
                high_water=0.75, cooldown_steps=2)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_engine_head128_streams_match_reference(quant, monkeypatch):
    """qwen2.5-3b-smoke at D = 128 with seeded QKV biases, f32 under axq8
    with the QoS ladder 8 -> 6: five requests on two slots, exact-length
    admission on the bf16 cache and bucketed, packed (pack 2) admission on
    the int8 cache; the port's greedy streams equal the JAX engine's on its
    Pallas route, and the degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    jm, jp, tm, tp = P.models("float32", "axq8", arch=QWEN, bias_seed=3, head_dim=D)
    rng = np.random.default_rng(128)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 20, 3, 12)]
    jadm, tadm = ((JAdmissionConfig(pack=2), AdmissionConfig(pack=2)) if quant
                  else (None, None))
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=jadm, emitter=False)
        jreqs = [jeng.submit(p, 6) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=tadm, emitter=False)
    assert isinstance(teng.cache, LMCacheQ) == quant
    assert teng.cache.k.shape[-1] == D
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg and {(8,), (6,)} <= set(tdeg), (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")
