"""Port parity of the Mamba-2 (SSD) family, ``repro_torch.models.ssm``, on
mamba2-370m-smoke against the JAX package, and of the pieces it shares with
the hybrid: the causal depthwise ``conv1d_apply``, ``_conv_tail``, the state
caches through ``convert`` and ``cache_ops``.

Inputs come from numpy seeds; the reference's params cross into the port
through ``convert``.  The model tests run the reference on its Pallas route
in interpret mode (``_torch_parity.jax_backend("pallas")``), whose AXQ
kernel the port's plain GEMM mirrors.

Tolerances: f32 logits and cache states atol 1e-4 (tests/test_torch_models
.py); bf16 logits atol 0.25 and the states' relative Frobenius error <= 3e-2
(tests/test_torch_models_bf16.py); the packs, the bucketed-vs-exact prefill
within the port and slot reuse bit for bit; the engines' greedy streams
equal up to near-ties below LOGIT_TOL (tests/test_torch_serve.py).

Two properties of the reference shape the bf16 and engine tests.  (1) In
bf16 under AXQ at 5-6 effective bits the reference's compiled program and
its own op-by-op evaluation (``jax.disable_jit``) differ by more than the
bf16 bounds (mamba2-370m-smoke, degree 6: logits 0.149, h 5.1e-2 relative:
XLA's fusions round f32 intermediates differently, and AXQ's int8 codes
amplify it), while the port equals the op-by-op evaluation (logits 0.0, h
7e-8 relative).  So the compiled reference is the bound at degree 8 and
EXACT, and the op-by-op one at the low degrees.  (2) The reference's decode
returns the conv tail in the compute dtype, so an f32 model's bf16 cache
turns f32 after its first step (a functional cache may change dtype).  The
engines here run on f32 caches; an f32 model on a bf16 cache is held to
the reference in tests/test_torch_conv_tail.py."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import get_config as jget_config
from repro.core.dynamic import QoSController as JQoS
from repro.kernels.qstore import prepack_params as jprepack_params
from repro.models import cache_ops as jcache_ops
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels.qstore import PackedQWeight, prepack_params
from repro_torch.models import cache_ops as tcache_ops
from repro_torch.models import layers as TL
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as TT
from repro_torch.models.registry import build_model
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

ARCH = "mamba2-370m-smoke"
ATOL = 1e-4
LOGIT_ATOL_BF16 = 0.25
STATE_REL_BF16 = 3e-2
LOGIT_TOL = 1e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return P.to_np(t)


def _rel(port, ref) -> float:
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


# ---------------------------------------------------------------------------
# conv1d and the conv tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,with_state", [(4, False), (4, True), (1, False), (3, True)])
def test_conv1d_apply_matches_reference(width, with_state):
    """The causal depthwise conv over (B, S, C), with and without a carried
    state (the decode form prepends it): output and the new state within
    1e-6 of the reference (the taps summed in f32, in order)."""
    rng = np.random.default_rng(width * 10 + with_state)
    B, S, C = 3, 7, 12
    p = {"w": rng.standard_normal((width, C)).astype(np.float32),
         "b": rng.standard_normal(C).astype(np.float32)}
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    st = rng.standard_normal((B, width - 1, C)).astype(np.float32) if with_state else None
    oj, sj = JL.conv1d_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             None if st is None else jnp.asarray(st))
    ot, stt = TL.conv1d_apply({k: _t(v) for k, v in p.items()}, _t(x),
                              None if st is None else _t(st))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(stt.numpy(), np.asarray(sj), rtol=0, atol=0)


def test_conv_tail_matches_reference_and_the_full_length_state():
    """``_conv_tail`` gathers each row's last ``width - 1`` inputs at its
    length (zeros where the row is shorter) as the reference does, and at
    the full length equals the state ``conv1d_apply`` keeps."""
    rng = np.random.default_rng(3)
    ci = rng.standard_normal((4, 9, 5)).astype(np.float32)
    lengths = np.array([0, 2, 9, 5], np.int32)
    oj = jssm._conv_tail(jnp.asarray(ci), jnp.asarray(lengths), 4)
    ot = tssm._conv_tail(_t(ci), _t(lengths), 4)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    p = {"w": torch.ones((4, 5)), "b": torch.zeros(5)}
    _, full = TL.conv1d_apply(p, _t(ci))
    assert torch.equal(tssm._conv_tail(_t(ci), torch.full((4,), 9), 4), full)


# ---------------------------------------------------------------------------
# the block, both forms
# ---------------------------------------------------------------------------


def _block(approx="exact", seed=0):
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jb = jax.tree.map(lambda a: a[0], jp["layers"])
    tb = TT.layer_params(tp["layers"], 0)
    return jm.cfg, tm.cfg, jm.policy, tm.policy, jb, tb


@pytest.mark.parametrize("S,lengths", [(16, None), (37, None), (37, (37, 20, 1, 0))])
def test_block_chunked_form_matches_reference(S, lengths):
    """The chunked dual form (one chunk, a padded tail past two chunks, and
    per-row lengths masking dt): output and the returned (h, conv) state
    within 1e-4."""
    jcfg, tcfg, jpol, tpol, jb, tb = _block()
    rng = np.random.default_rng(S)
    B = 4 if lengths else 2
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    ln = None if lengths is None else np.array(lengths, np.int32)
    with P.jax_backend("pallas"):
        yj, (hj, cj) = jssm.ssm_block_apply(jb, jnp.asarray(x), jcfg, jpol, "layer",
                                            return_state=True,
                                            lengths=None if ln is None else jnp.asarray(ln))
    yt, (ht, ct) = tssm.ssm_block_apply(tb, _t(x), tcfg, tpol, "layer", return_state=True,
                                        lengths=None if ln is None else _t(ln))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=ATOL)


def test_block_recurrent_form_matches_reference_and_the_chunked_form():
    """The one-step recurrent update from a carried (h, conv) state equals
    the reference's; stepping it over a sequence gives the chunked form's
    outputs and final state (the duality) within 1e-4."""
    jcfg, tcfg, jpol, tpol, jb, tb = _block()
    rng = np.random.default_rng(11)
    B, S = 2, 6
    d_in, H, Pd, N = tssm._dims(tcfg)
    x = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((B, H, Pd, N)).astype(np.float32) * 0.1
    c0 = rng.standard_normal((B, 3, d_in + 2 * N)).astype(np.float32)
    yj, (hj, cj) = jssm.ssm_block_apply(jb, jnp.asarray(x), jcfg, jpol, "layer",
                                        state=(jnp.asarray(h0), jnp.asarray(c0)))
    yt, (ht, ct) = tssm.ssm_block_apply(tb, _t(x), tcfg, tpol, "layer",
                                        state=(_t(h0), _t(c0)))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    xs = _t(rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32))
    yc, (hc, cc) = tssm.ssm_block_apply(tb, xs, tcfg, tpol, "layer", return_state=True)
    h, c = torch.zeros((B, H, Pd, N)), torch.zeros((B, 3, d_in + 2 * N))
    ys = []
    for t in range(S):
        y, (h, c) = tssm.ssm_block_apply(tb, xs[:, t:t + 1], tcfg, tpol, "layer",
                                         state=(h, c))
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), yc.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), hc.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(c, cc)


# ---------------------------------------------------------------------------
# the model: forward, prefill, prefill_batch, decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6), ("axq8", "vector")])
def test_forward_matches_reference(approx, degree):
    """``ssm_forward``'s logits on a (2, 21) batch within 1e-4, the aux
    loss zero."""
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(4).integers(0, 512, (2, 21)).astype(np.int32)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
    lt, at = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    assert float(at) == 0.0


@pytest.mark.parametrize("approx,degree,P_len", [
    ("exact", None, 37), ("axq8", 8, 16), ("axq8", 6, 37), ("axq8", "vector", 5)])
def test_prefill_decode_match_reference(approx, degree, P_len):
    """``ssm_prefill`` (one chunk exactly, a padded chunk tail, a prompt
    shorter than the conv) then ``ssm_decode_step`` with slot 0 free, in
    f32 on an f32 cache: logits, h and the conv tail within 1e-4."""
    for stage in P.run_state_prefill_decode("float32", approx, degree, prompt_len=P_len,
                                            arch=ARCH):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


def _check_bf16(stages):
    for stage in stages:
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("h", "conv"):
            assert _rel(*stage[name][::-1]) <= STATE_REL_BF16, name


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8)])
def test_prefill_decode_bf16_match_reference(approx, degree):
    """The same in bf16 on the bf16 conv cache (h stays f32), against the
    compiled reference, at tests/test_torch_models_bf16.py's tolerances."""
    _check_bf16(P.run_state_prefill_decode("bfloat16", approx, degree, prompt_len=37,
                                           arch=ARCH))


@pytest.mark.parametrize("approx,degree", [("axq8", "vector")])
def test_prefill_decode_bf16_match_op_by_op_reference(approx, degree):
    """In bf16 under AXQ at degrees 6 and 5 (a per-site vector), against the
    reference evaluated op by op (the module docstring: its compiled form
    is further from its own op-by-op form than these bounds), at
    tests/test_torch_models_bf16.py's tolerances."""
    _check_bf16(P.run_state_prefill_decode("bfloat16", approx, degree, prompt_len=16,
                                           compiled=False, arch=ARCH))


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", "vector")])
def test_prefill_batch_matches_reference(approx, degree):
    """``ssm_prefill_batch`` on rows padded to a 40-token bucket, one of
    them a dummy (slot 5, outside the cache) and one a live row of length
    0: every cache field within 1e-4 of the reference's, the dummy writing
    nothing."""
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    lens = [40, 17, 3, 0]
    slots = [2, 0, 5, 1]
    _, toks = P.padded_rows(lens, 40, 9)
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=3, max_len=48, dtype=jnp.float32)
        jc = jc._replace(h=jc.h + 0.5)               # a dummy must not touch this
        tc = P.port_cache(jc)
        jc = jax.jit(jm.prefill_batch)(jp, jc, jnp.asarray(toks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    tc = tm.prefill_batch(tp, tc, _t(toks).long(), slots, lens, degree=tdeg)
    for f in tc._fields:
        np.testing.assert_allclose(_np(getattr(tc, f)), _np(getattr(jc, f)), rtol=0,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("seed,lens,Pb", [(0, (5, 16, 31, 2), 32), (1, (40, 3, 17, 33), 64),
                                          (2, (1, 48, 12, 20), 128)])
def test_bucketed_prefill_is_bit_identical_to_exact(seed, lens, Pb):
    """Within the port: rows padded to one bucket (chunk counts that differ
    from the exact prompt's included) give each row's exact-length state
    bit for bit, on fixed seeds, in bf16 under axq8 at degree 6; the
    device-tensor form of ``slots`` / ``lengths`` (the captured call's)
    equals the host form."""
    _, _, tm, tp = P.models("bfloat16", "axq8", arch=ARCH)
    deg = torch.tensor(6, dtype=torch.int32)
    rows, toks = P.padded_rows(lens, Pb, seed)
    exact = tm.init_cache(1, len(lens), Pb)
    for i, r in enumerate(rows):
        tm.prefill(tp, exact, _t(r).long(), i, degree=deg)
    padded = tm.prefill_batch(tp, tm.init_cache(1, len(lens), Pb), _t(toks).long(),
                              list(range(len(lens))), list(lens), degree=deg)
    dev = tm.prefill_batch(tp, tm.init_cache(1, len(lens), Pb), _t(toks).long(),
                           torch.arange(len(lens)), torch.tensor(lens), degree=deg)
    for f in exact._fields:
        assert torch.equal(getattr(exact, f), getattr(padded, f)), f
        assert torch.equal(getattr(dev, f), getattr(padded, f)), f


def test_slot_reuse_equals_a_fresh_slot():
    """A slot that served one prompt and decoded, then takes a new prompt,
    holds exactly what a fresh cache's slot holds after that prompt, and
    the next step's logits are equal."""
    _, _, tm, tp = P.models("float32", "axq8", arch=ARCH)
    rng = np.random.default_rng(13)
    a, b = (_t(rng.integers(0, 512, n)).long() for n in (23, 11))
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    used = tm.init_cache(1, 2, 32, dtype=torch.float32)
    tm.prefill(tp, used, a, 0)
    tm.decode_step(tp, used, toks)
    fresh = tm.init_cache(1, 2, 32, dtype=torch.float32)
    fresh.length[1] = used.length[1]
    fresh.h[:, 1], fresh.conv[:, 1] = used.h[:, 1], used.conv[:, 1]
    l_used, _ = tm.prefill(tp, used, b, 0)
    l_fresh, _ = tm.prefill(tp, fresh, b, 0)
    assert torch.equal(l_used, l_fresh)
    for f in used._fields:
        assert torch.equal(getattr(used, f), getattr(fresh, f)), f


def test_cache_is_the_state_and_does_not_grow_with_max_len():
    """``init_cache`` returns the state cache whatever ``quant`` or
    REPRO_KV_INT8 say; its bytes do not depend on max_len."""
    model = build_model(tget_config(ARCH), device="cpu")
    sizes = set()
    for max_len, quant in ((16, None), (4096, True), (1 << 20, False)):
        c = model.init_cache(1, 3, max_len, quant=quant)
        assert isinstance(c, tssm.SSMCache)
        sizes.add(sum(t.numel() * t.element_size() for t in c))
    assert len(sizes) == 1


# ---------------------------------------------------------------------------
# packs, convert, cache_ops
# ---------------------------------------------------------------------------


def test_packs_through_convert_match_prepack():
    """The reference's packed tree through ``params_from_numpy`` equals the
    port's ``prepack_params`` of the converted float tree bit for bit: the
    stacked in_proj / out_proj packs and the tied unembedding's
    ``unembed_q``; the conv, dt and norm leaves stay f32."""
    jm, jp_packed, _, tp_packed = P.models("float32", "axq8", arch=ARCH)
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    pol = ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8, dynamic=True))
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tget_config(ARCH),
                        pol)
    for a, b in ((tp_packed["layers"]["in_proj"]["w"], tp["layers"]["in_proj"]["w"]),
                 (tp_packed["layers"]["out_proj"]["w"], tp["layers"]["out_proj"]["w"]),
                 (tp_packed["embed"]["unembed_q"], tp["embed"]["unembed_q"])):
        assert isinstance(a, PackedQWeight) and isinstance(b, PackedQWeight)
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scales, b.scales)
    assert tp["layers"]["in_proj"]["w"].qw.shape[0] == tget_config(ARCH).n_layers
    for key in ("conv", "dt_bias", "a_log", "D"):
        assert not isinstance(tp["layers"][key], PackedQWeight)
    jpk = jprepack_params(jp, jget_config(ARCH), jm.policy)
    assert np.array_equal(np.asarray(jpk["layers"]["in_proj"]["w"].qw),
                          tp["layers"]["in_proj"]["w"].qw.numpy())


def test_cache_ops_on_the_state_cache_match_reference():
    """``cache_reset_slot`` (host and masked device forms),
    ``cache_mask_update`` and ``cache_bit_flip`` on an SSMCache follow the
    reference's layout convention (batch at axis 1, length at axis 0)."""
    jm, _, _, _ = P.models("float32", "exact", arch=ARCH)
    jc = jm.init_cache(tp=1, batch=3, max_len=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)
                                            if a.dtype != jnp.int32
                                            else rng.integers(1, 9, a.shape).astype(np.int32)),
                      jc)
    jr = jcache_ops.cache_reset_slot(jc, 1)
    tr = tcache_ops.cache_reset_slot(cache_from_numpy(jax.tree.map(np.asarray, jc)), 1)
    tm = tcache_ops.cache_reset_slot(cache_from_numpy(jax.tree.map(np.asarray, jc)),
                                     torch.tensor([1, 2]), mask=torch.tensor([True, False]))
    for f in jc._fields:
        np.testing.assert_array_equal(_np(getattr(tr, f)), _np(getattr(jr, f)))
        np.testing.assert_array_equal(_np(getattr(tm, f)), _np(getattr(jr, f)))
    active = np.array([True, False, True])
    jn = jc._replace(length=jc.length + 1)
    ju = jcache_ops.cache_mask_update(jc, jn, jnp.asarray(active))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc))
    tu = tcache_ops.cache_mask_update(tc, tc._replace(length=tc.length + 1),
                                      torch.from_numpy(active), into=tc)
    np.testing.assert_array_equal(_np(tu.length), _np(ju.length))
    jf = jcache_ops.cache_bit_flip(jc, "h", 2, 7, 30)
    tf = tcache_ops.cache_bit_flip(cache_from_numpy(jax.tree.map(np.asarray, jc)), "h", 2, 7,
                                   30)
    np.testing.assert_array_equal(_np(tf.h), _np(jf.h))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


def f32_caches(monkeypatch, jm, tm) -> None:
    """Both engines' models make f32 caches (the module docstring)."""
    monkeypatch.setattr(jm, "init_cache", functools.partial(type(jm).init_cache, jm,
                                                            dtype=jnp.float32))
    monkeypatch.setattr(tm, "init_cache", functools.partial(type(tm).init_cache, tm,
                                                            dtype=torch.float32))


@pytest.mark.parametrize("admission", [False, True], ids=["exact", "buckets-pack2"])
def test_engine_streams_match_reference(admission, monkeypatch):
    """Five requests on two slots in f32 on f32 caches under axq8 with the
    QoS ladder 8 -> 6, exact-length or bucketed packed admission (one
    prompt past the largest bucket): the port's greedy streams equal the
    JAX engine's on its Pallas route, and the degree walks the same
    rungs."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=ARCH)
    f32_caches(monkeypatch, jm, tm)
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 40, 14, 3, 11)]
    jadm = JAdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    tadm = AdmissionConfig(buckets=(8, 16), pack=2) if admission else None
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=jadm, emitter=False)
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()), admission=tadm,
                       emitter=False)
    assert isinstance(teng.cache, tssm.SSMCache)
    assert teng.workload._max_prompt is None and not teng.workload._chunk_ok
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 5) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 5, LOGIT_TOL)
    assert (teng.workload.trace_counts["prefill_batch"] > 0) == admission
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg, (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
def test_launch_serve_under_qos(buckets):
    """``launch.serve --arch mamba2-370m-smoke --device cpu --approx axq8
    --qos`` (with ``--prefill-buckets auto --pack 4``, and a chunk size
    asked for, which the SSM does not take): every request finishes with
    its tokens, the ladder moves, the weights are packed."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", ARCH, "--device", "cpu", "--approx", "axq8", "--qos",
            "--requests", "6", "--new-tokens", "5", "--max-len", "64"]
    if buckets:
        argv += ["--prefill-buckets", "auto", "--pack", "4", "--chunk-tokens", "16"]
    s, eng = launch_serve.run(argv)
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, tssm.SSMCache)
    assert (eng.workload.admission is not None) == buckets
    assert eng.workload.trace_counts["prefill_chunk"] == 0
    assert isinstance(eng.params["layers"]["in_proj"]["w"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1


def test_full_width_builds_with_its_widths():
    """mamba2-370m builds at its registered widths (a meta-device init):
    48 stacked layers, the fused in_proj N = 2 * 2048 + 2 * 128 + 32 =
    4384, the tied 50280-row embedding; its state cache 8 slots x 48 x 32
    x 64 x 128 f32."""
    cfg = tget_config("mamba2-370m")
    TT.check_supported(cfg)
    params = tssm.init_ssm_lm(torch.Generator(), cfg, device="meta")
    assert params["layers"]["in_proj"]["w"].shape == (48, 1024, 4384)
    assert params["embed"]["emb"].shape == (50280, 1024) and "unembed" not in params
    c = tssm.init_ssm_cache(cfg, 1, 8, 8192, device="meta")
    assert c.h.shape == (48, 8, 32, 64, 128) and c.conv.shape == (48, 8, 3, 2304)


def test_smoke_config_is_the_reference_config():
    """The port's smoke config equals the reference's field for field."""
    assert dataclasses.asdict(tget_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))


def test_quality_tap_leaves_the_state_cache_as_it_found_it():
    """The logit-RMS probe (``obs/quality.py``) runs two decode steps on the
    live cache and restores what they wrote: for the SSM the whole h and
    conv fields; every field bit for bit after it, its value finite and
    positive at a low rung."""
    from repro_torch.obs.quality import lm_logit_rms_probe

    _, _, tm, tp = P.models("float32", "axq8", arch=ARCH)
    cache = tm.init_cache(1, 2, 32)
    rng = np.random.default_rng(3)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 20)).long(), 0)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 7)).long(), 1)
    before = [t.clone() for t in cache]
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    val = lm_logit_rms_probe(tm)(tp, cache, toks, torch.tensor([True, True]),
                                 torch.tensor(5, dtype=torch.int32),
                                 torch.tensor(8, dtype=torch.int32))
    assert 0 < float(val) < float("inf")
    for a, b in zip(before, cache):
        assert torch.equal(a, b)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8)])
def test_forward_and_prefill_batch_bf16_match_reference(approx, degree):
    """In bf16 against the compiled reference, at tests/test_torch_models_
    bf16.py's tolerances: ``ssm_forward``'s logits, and every state field
    after ``ssm_prefill_batch`` (three rows in a 40-token bucket)."""
    jm, jp, tm, tp = P.models("bfloat16", approx, arch=ARCH)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(6).integers(0, 512, (2, 21)).astype(np.int32)
    lens, slots = [40, 17, 3], [2, 0, 1]
    _, btoks = P.padded_rows(lens, 40, 8)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
        jc = jax.jit(jm.prefill_batch)(jp, jm.init_cache(tp=1, batch=3, max_len=48),
                                       jnp.asarray(btoks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    lt, _ = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=LOGIT_ATOL_BF16)
    tc = tm.prefill_batch(tp, tm.init_cache(1, 3, 48), _t(btoks).long(), slots, lens,
                          degree=tdeg)
    for f in ("h", "conv"):
        assert _rel(_np(getattr(tc, f)), _np(getattr(jc, f))) <= STATE_REL_BF16, f
