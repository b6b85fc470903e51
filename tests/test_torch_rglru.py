"""Port parity of the RG-LRU hybrid family, ``repro_torch.models.rglru``, on
recurrentgemma-2b-smoke against the JAX package, and of head_dim 256 in the
two attention kernels the hybrid reaches (MQA 10/1 at recurrentgemma-2b's
widths).

The smoke arch has 3 layers (one (rec, rec, attn) group, no tail); the
model tests override it to 4 on both sides, one group and one tail block,
so that the tail's paths and degrees are covered.  Inputs come from numpy
seeds; the reference's params cross through ``convert``; the reference runs
on its Pallas route in interpret mode.

Tolerances, as tests/test_torch_ssm.py: f32 atol 1e-4; bf16 logits atol
0.25 and the caches' relative Frobenius error <= 3e-2 against the compiled
reference at EXACT and degrees 8 and 6, and against the op-by-op reference
at a per-site vector down to 5 (tests/test_torch_ssm.py's docstring: at
degrees 8 to 5 and a 45-token prompt the compiled reference differs from
its own op-by-op evaluation by 0.219 in the logits and 5.4e-2 relative in
the conv tails, while the port equals the op-by-op one: 0.0); the
doubling scan against ``jax.lax.associative_scan`` at
f32 atol 1e-5 (ROADMAP §C records the largest difference); packs,
bucketed-vs-exact within the port and slot reuse bit for bit; engines on
f32 caches, streams equal up to near-ties below LOGIT_TOL.  The kernels'
plain versions at D = 256: rtol 1e-5 / atol 1e-4 (tests/test_torch_
head128.py)."""
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
from repro.kernels import flash_attention as jfa
from repro.kernels import flash_decode as jfd
from repro.kernels.qstore import prepack_params as jprepack_params
from repro.models import cache_ops as jcache_ops
from repro.models import rglru as jrg
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels.axqmm import ACTS
from repro_torch.kernels.qstore import PackedQWeight, prepack_params
from repro_torch.models import cache_ops as tcache_ops
from repro_torch.models import layers as TL
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as TT
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine

torch.set_num_threads(2)

ARCH = "recurrentgemma-2b-smoke"
LAYERS = 4            # one (rec, rec, attn) group and one tail block
ATOL = 1e-4
SCAN_ATOL = 1e-5
LOGIT_ATOL_BF16 = 0.25
CACHE_REL_BF16 = 3e-2
LOGIT_TOL = 1e-2
RTOL_K, ATOL_K = 1e-5, 1e-4
D = 256


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t) -> np.ndarray:
    return P.to_np(t)


def _rel(port, ref) -> float:
    return float(np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30))


def _models(dtype="float32", approx="axq8"):
    return P.models(dtype, approx, arch=ARCH, n_layers=LAYERS)


# ---------------------------------------------------------------------------
# degrees, the scan, the block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "recurrentgemma-2b-smoke"])
@pytest.mark.parametrize("kind", [None, 6, "vector"])
def test_group_degrees_match_reference(arch, kind):
    """The group-major split of a runtime degree into (groups x pattern,
    tail, head) equals the reference's ``_group_degrees``: 26 layers as 8
    groups of 3 and 2 tail blocks, and the smoke's one group."""
    cfg = tget_config(arch)
    n = cfg.n_layers + 1
    if kind == "vector":
        vals = [8 - (i % 4) for i in range(n)]
        jdeg, tdeg = jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    else:
        jdeg, tdeg = P.degrees(kind)
    jg, jt, jh = jrg._group_degrees(jdeg, jget_config(arch))
    tg, tt, th = trg._group_degrees(tdeg, cfg)
    if kind is None:
        assert jg is jt is jh is tg is tt is th is None
        return
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert int(th) == int(jh)
    assert tuple(tg.shape) == (cfg.n_layers // 3, 3)
    hosted, _, _ = trg._group_degrees(7, cfg)
    assert hosted == [[7, 7, 7]] * (cfg.n_layers // 3)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_doubling_scan_matches_associative_scan(S):
    """The Hillis-Steele doubling scan against the reference's
    ``jax.lax.associative_scan`` on the same (B, S, d) f32 inputs (decays
    in (0, 1) as the block makes them), with and without an initial state,
    within f32 atol 1e-5."""
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 6)).astype(np.float32)
    a = rng.uniform(0.05, 0.999, (2, S, 6)).astype(np.float32)
    h0 = rng.standard_normal((2, 6)).astype(np.float32)
    for init in (None, h0):
        hj = jrg._rglru_scan(jnp.asarray(x), jnp.asarray(a),
                             None if init is None else jnp.asarray(init))
        ht = trg._rglru_scan(_t(x), _t(a), None if init is None else _t(init))
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=SCAN_ATOL)


def test_doubling_scan_does_not_depend_on_the_padded_length():
    """Every prefix of the scan is bit-identical whatever the padded length
    past it (each position depends only on positions at or before it)."""
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((3, 100, 8)).astype(np.float32))
    a = _t(rng.uniform(0.05, 0.999, (3, 100, 8)).astype(np.float32))
    full = trg._rglru_scan(x, a)
    for n in (1, 5, 31, 32, 33, 64, 99):
        assert torch.equal(trg._rglru_scan(x[:, :n], a[:, :n]), full[:, :n]), n


def _block():
    jm, jp, tm, tp = _models("float32", "exact")
    jb = jax.tree.map(lambda a: a[0], jp["groups"]["rec0"])
    tb = TT.layer_params(tp["groups"]["rec0"], 0)
    return jm, tm, jb, tb


@pytest.mark.parametrize("lengths", [None, (9, 4, 1, 0)])
def test_rec_block_prefill_form_matches_reference(lengths):
    """The recurrent block's scan form (the last position's state, or each
    row's at its length with a zero state for length 0): output, h and
    the conv tail within 1e-4."""
    jm, tm, jb, tb = _block()
    rng = np.random.default_rng(1)
    B = 4 if lengths else 2
    x = rng.standard_normal((B, 9, tm.cfg.d_model)).astype(np.float32)
    ln = None if lengths is None else np.array(lengths, np.int32)
    yj, (hj, cj) = jrg.rec_block_apply(jb, jnp.asarray(x), jm.cfg, jm.policy, "g",
                                       lengths=None if ln is None else jnp.asarray(ln))
    yt, (ht, ct) = trg.rec_block_apply(tb, _t(x), tm.cfg, tm.policy, "g",
                                       lengths=None if ln is None else _t(ln))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)


def test_rec_block_decode_form_matches_reference_and_the_scan_form():
    """The one-step update from a carried (h, conv) state equals the
    reference's; stepping it over a sequence from zeros gives the scan
    form's outputs and final state within 1e-4."""
    jm, tm, jb, tb = _block()
    rng = np.random.default_rng(2)
    d = tm.cfg.d_model
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    h0 = rng.standard_normal((2, d)).astype(np.float32)
    c0 = rng.standard_normal((2, 3, d)).astype(np.float32)
    yj, (hj, cj) = jrg.rec_block_apply(jb, jnp.asarray(x), jm.cfg, jm.policy, "g",
                                       state=(jnp.asarray(h0), jnp.asarray(c0)))
    yt, (ht, ct) = trg.rec_block_apply(tb, _t(x), tm.cfg, tm.policy, "g",
                                       state=(_t(h0), _t(c0)))
    for a, b in ((yt, yj), (ht, hj), (ct, cj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL)
    xs = _t(rng.standard_normal((2, 7, d)).astype(np.float32))
    ys_scan, (h_scan, c_scan) = trg.rec_block_apply(tb, xs, tm.cfg, tm.policy, "g")
    h, c, ys = torch.zeros((2, d)), torch.zeros((2, 3, d)), []
    for t in range(7):
        y, (h, c) = trg.rec_block_apply(tb, xs[:, t:t + 1], tm.cfg, tm.policy, "g",
                                        state=(h, c))
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), ys_scan.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(h.numpy(), h_scan.numpy(), rtol=0, atol=ATOL)
    assert torch.equal(c, c_scan)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6),
                                           ("axq8", (8, 6, 7, 5, 6))])
def test_forward_matches_reference(approx, degree):
    """``hybrid_forward``'s logits on a (2, 40) batch (past the window of
    32) within 1e-4, the aux loss zero."""
    jm, jp, tm, tp = _models("float32", approx)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(4).integers(0, 512, (2, 40)).astype(np.int32)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
    lt, at = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL)
    assert float(at) == 0.0


def run_prefill_decode(dtype, approx, degree, prompt_len=20, **kw):
    return P.run_state_prefill_decode(dtype, approx, degree, prompt_len=prompt_len,
                                      arch=ARCH, n_layers=LAYERS, **kw)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8), ("axq8", 6),
                                           ("axq8", (8, 6, 7, 5, 6))])
def test_prefill_decode_match_reference(approx, degree):
    """``hybrid_prefill`` then ``hybrid_decode_step`` (slot 0 free) in f32
    on an f32 cache: logits, the attention ring, h and the conv tails
    within 1e-4."""
    for stage in run_prefill_decode("float32", approx, degree):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("prompt_len,steps", [(31, 3), (32, 2), (40, 6), (70, 4)])
def test_ring_wrap_past_the_window_matches_reference(prompt_len, steps):
    """Prompts at, past and twice past the window of 32 (the prefill writes
    its last 32 tokens at ``j % 32``, ``band`` attention), then decode
    steps that wrap the ring again: every stage within 1e-4 in f32 under
    axq8 at degree 6."""
    for stage in run_prefill_decode("float32", "axq8", 6, prompt_len=prompt_len, steps=steps,
                                    max_len=64):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


def _check_bf16(stages):
    for stage in stages:
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("k", "v", "h", "conv"):
            assert _rel(*stage[name][::-1]) <= CACHE_REL_BF16, name


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 8), ("axq8", 6)])
def test_prefill_decode_bf16_match_reference(approx, degree):
    """The same in bf16 on the bf16 cache (h f32) against the compiled
    reference, prompts within and past the window, at tests/test_torch_
    models_bf16.py's tolerances."""
    _check_bf16(run_prefill_decode("bfloat16", approx, degree, steps=2))
    _check_bf16(run_prefill_decode("bfloat16", approx, degree, prompt_len=45, max_len=64))


def test_prefill_decode_bf16_match_op_by_op_reference():
    """In bf16 under AXQ at degrees 8 to 5 (a per-site vector), against the
    reference evaluated op by op, at tests/test_torch_models_bf16.py's
    tolerances (the module docstring: at this degree and a 45-token prompt
    the compiled reference is 5.4e-2 away from its own op-by-op form)."""
    _check_bf16(run_prefill_decode("bfloat16", "axq8", (8, 6, 7, 5, 6), prompt_len=12,
                                   steps=2, compiled=False))


@pytest.mark.parametrize("degree", [6, (8, 6, 7, 5, 6)])
def test_rounded_activations_hold_bf16_parity(degree, monkeypatch):
    """The recurrent blocks' op-by-op activations (``layers.act_rounded``)
    are what holds bf16 parity at the low degrees: with them the port sits
    within the bounds of the reference evaluated op by op (at degree 6 the
    compiled one is the same program: test_prefill_decode_bf16_match_
    reference), while the GEMM epilogue's fused forms (``ACTS``:
    ``F.silu``, ``F.gelu``) put the logits past the bf16 bound (PERF.md,
    PR 24)."""
    rounded = run_prefill_decode("bfloat16", "axq8", degree, steps=2, compiled=False)
    _check_bf16(rounded)
    for name in ("silu", "gelu"):
        monkeypatch.setitem(TL._ROUNDED_ACTS, name, ACTS[name])
    fused = run_prefill_decode("bfloat16", "axq8", degree, steps=2, compiled=False)

    def worst(stages):
        return max(float(np.abs(s["logits"][1] - s["logits"][0]).max()) for s in stages)

    print(f"degree {degree}: rounded {worst(rounded)}, fused {worst(fused)}")
    assert worst(fused) > max(worst(rounded), LOGIT_ATOL_BF16)


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", (8, 6, 7, 5, 6))])
def test_prefill_batch_matches_reference(approx, degree):
    """``hybrid_prefill_batch`` on rows padded to a 48-token bucket (past
    the window: the masked tail scatter keeps each row's last 32 tokens),
    one dummy row (slot 7) and one live row of length 0: every cache field
    within 1e-4 of the reference's, the dummy writing nothing."""
    jm, jp, tm, tp = _models("float32", approx)
    jdeg, tdeg = P.degrees(degree)
    lens = [48, 17, 3, 0]
    slots = [2, 0, 7, 1]
    _, toks = P.padded_rows(lens, 48, 9)
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=3, max_len=64, dtype=jnp.float32)
        jc = jc._replace(h=jc.h + 0.5, k=jc.k + 0.25)      # a dummy must not touch these
        tc = P.port_cache(jc)
        jc = jax.jit(jm.prefill_batch)(jp, jc, jnp.asarray(toks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    tc = tm.prefill_batch(tp, tc, _t(toks).long(), slots, lens, degree=tdeg)
    for f in tc._fields:
        np.testing.assert_allclose(_np(getattr(tc, f)), _np(getattr(jc, f)), rtol=0,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("seed,lens,Pb", [(0, (5, 16, 31, 2), 32), (1, (40, 3, 17, 33), 64),
                                          (2, (1, 64, 12, 20), 128)])
def test_bucketed_prefill_is_bit_identical_to_exact(seed, lens, Pb):
    """Within the port: rows padded to one bucket (past the window of 32
    included) give each row's exact-length cache region bit for bit, on
    fixed seeds, in bf16 under axq8 at degree 6; the device-tensor form of
    ``slots`` / ``lengths`` equals the host form."""
    _, _, tm, tp = _models("bfloat16", "axq8")
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
    """A slot that served a prompt past the window and decoded, then takes
    a new prompt, holds exactly what a fresh cache's slot holds after it,
    and the next step's logits are equal."""
    _, _, tm, tp = _models("float32", "axq8")
    rng = np.random.default_rng(13)
    a, b = (_t(rng.integers(0, 512, n)).long() for n in (45, 11))
    toks = _t(rng.integers(0, 512, (2, 1))).long()
    used = tm.init_cache(1, 2, 64, dtype=torch.float32)
    tm.prefill(tp, used, a, 0)
    tm.decode_step(tp, used, toks)
    fresh = tm.init_cache(1, 2, 64, dtype=torch.float32)
    for f in used._fields:
        if f == "length":
            fresh.length[1] = used.length[1]
        else:
            getattr(fresh, f)[:, 1] = getattr(used, f)[:, 1]
    l_used, _ = tm.prefill(tp, used, b, 0)
    l_fresh, _ = tm.prefill(tp, fresh, b, 0)
    assert torch.equal(l_used, l_fresh)
    for f in used._fields:
        assert torch.equal(getattr(used, f), getattr(fresh, f)), f
    lu, _ = tm.decode_step(tp, used, toks)
    lf, _ = tm.decode_step(tp, fresh, toks)
    assert torch.equal(lu, lf)


# ---------------------------------------------------------------------------
# packs, convert, cache_ops
# ---------------------------------------------------------------------------


def test_packs_through_convert_match_prepack():
    """The reference's packed tree through ``params_from_numpy`` (the
    ``tail`` list included) equals the port's ``prepack_params`` of the
    converted float tree bit for bit: every group block's projections and
    gated MLP (stacked over groups), the tail block's, the unembedding; the
    recurrence parameters and the embedding stay f32."""
    jm, jp_packed, tm, tp_packed = _models("float32", "axq8")
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    pol = ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8, dynamic=True))
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tm.cfg, pol)
    pairs = [(tp_packed["unembed"]["w"], tp["unembed"]["w"])]
    for gkey, keys in (("rec0", ("wx", "wg", "wa", "wi", "wo")),
                       ("rec1", ("wx", "wg", "wa", "wi", "wo")),
                       ("attn2", ("wq", "wk", "wv", "wo"))):
        pairs += [(tp_packed["groups"][gkey][k]["w"], tp["groups"][gkey][k]["w"])
                  for k in keys]
        pairs += [(tp_packed["groups"][gkey]["mlp"][k]["w"], tp["groups"][gkey]["mlp"][k]["w"])
                  for k in ("up", "gate", "down")]
    assert isinstance(tp_packed["tail"], list) and len(tp_packed["tail"]) == 1
    pairs += [(tp_packed["tail"][0]["wx"]["w"], tp["tail"][0]["wx"]["w"]),
              (tp_packed["tail"][0]["mlp"]["down"]["w"], tp["tail"][0]["mlp"]["down"]["w"])]
    for a, b in pairs:
        assert isinstance(a, PackedQWeight) and isinstance(b, PackedQWeight)
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scales, b.scales)
    assert tp["groups"]["rec0"]["wx"]["w"].qw.shape[0] == 1          # stacked over groups
    for leaf in (tp["groups"]["rec0"]["lam"], tp["tail"][0]["conv"]["w"], tp["embed"]["emb"]):
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float32
    jcfg = dataclasses.replace(jget_config(ARCH), n_layers=LAYERS)
    jpk = jprepack_params(jp, jcfg, jm.policy)
    assert np.array_equal(np.asarray(jpk["tail"][0]["wo"]["w"].qw),
                          tp["tail"][0]["wo"]["w"].qw.numpy())


def test_cache_ops_on_the_hybrid_cache_match_reference():
    """``cache_reset_slot`` (host and masked device forms),
    ``cache_mask_update`` and ``cache_bit_flip`` on a HybridCache follow the
    reference's layout convention on every field (the rings, h, conv)."""
    jm, _, _, _ = _models("float32", "exact")
    jc = jm.init_cache(tp=1, batch=3, max_len=16, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    jc = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(a.dtype)
                                            if a.dtype != jnp.int32
                                            else rng.integers(1, 9, a.shape).astype(np.int32)),
                      jc)
    fresh = lambda: cache_from_numpy(jax.tree.map(np.asarray, jc))
    jr = jcache_ops.cache_reset_slot(jc, 2)
    tr = tcache_ops.cache_reset_slot(fresh(), 2)
    tm = tcache_ops.cache_reset_slot(fresh(), torch.tensor([0, 2]),
                                     mask=torch.tensor([False, True]))
    for f in jc._fields:
        np.testing.assert_array_equal(_np(getattr(tr, f)), _np(getattr(jr, f)))
        np.testing.assert_array_equal(_np(getattr(tm, f)), _np(getattr(jr, f)))
    active = np.array([False, True, True])
    ju = jcache_ops.cache_mask_update(jc, jc._replace(length=jc.length + 1), jnp.asarray(active))
    tc = fresh()
    tu = tcache_ops.cache_mask_update(tc, tc._replace(length=tc.length + 1),
                                      torch.from_numpy(active), into=tc)
    np.testing.assert_array_equal(_np(tu.length), _np(ju.length))
    for name, index, bit in (("k", 40, 31), ("h", 3, 12), ("conv", 17, 0)):
        jf = jcache_ops.cache_bit_flip(jc, name, 1, index, bit)
        tf = tcache_ops.cache_bit_flip(fresh(), name, 1, index, bit)
        np.testing.assert_array_equal(_np(getattr(tf, name)), _np(getattr(jf, name)))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


@pytest.mark.parametrize("admission", [False, True], ids=["exact", "buckets-pack2"])
def test_engine_streams_match_reference(admission, monkeypatch):
    """Five requests on two slots in f32 on f32 caches (tests/test_torch_
    ssm.py's docstring) under axq8 with the QoS ladder 8 -> 6, one prompt
    past the window, exact-length or bucketed packed admission: the port's
    greedy streams equal the JAX engine's on its Pallas route, and the
    degree walks the same rungs."""
    jm, jp, tm, tp = _models("float32", "axq8")
    monkeypatch.setattr(jm, "init_cache", functools.partial(type(jm).init_cache, jm,
                                                            dtype=jnp.float32))
    monkeypatch.setattr(tm, "init_cache", functools.partial(type(tm).init_cache, tm,
                                                            dtype=torch.float32))
    rng = np.random.default_rng(31)
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
    assert isinstance(teng.cache, trg.HybridCache) and teng.cache.k.shape[2] == 32
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


def test_prompt_bound_follows_the_local_window():
    """The adapter bounds prompts by the cache only when the local window
    does not fit in max_len (the ring wraps only then), as the reference."""
    from repro_torch.models.registry import build_model
    from repro_torch.serve.lm import LMAdapter

    model = build_model(tget_config(ARCH), device="cpu")
    assert LMAdapter(model, max_len=32)._max_prompt is None
    assert LMAdapter(model, max_len=16)._max_prompt == 16
    with pytest.raises(ValueError, match="exceeds cache capacity"):
        LMAdapter(model, max_len=16).validate(np.arange(17))


@pytest.mark.parametrize("buckets", [False, True], ids=["exact", "buckets"])
def test_launch_serve_under_qos(buckets):
    """``launch.serve --arch recurrentgemma-2b-smoke --device cpu --approx
    axq8 --qos`` (with ``--prefill-buckets auto --pack 4`` and a chunk size,
    which the hybrid does not take): every request finishes with its
    tokens, the ladder moves, the weights are packed against the serve-time
    paths."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", ARCH, "--device", "cpu", "--approx", "axq8", "--qos",
            "--requests", "6", "--new-tokens", "5", "--max-len", "64"]
    if buckets:
        argv += ["--prefill-buckets", "auto", "--pack", "4", "--chunk-tokens", "16"]
    s, eng = launch_serve.run(argv)
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, trg.HybridCache)
    assert (eng.workload.admission is not None) == buckets
    assert eng.workload.trace_counts["prefill_chunk"] == 0
    assert isinstance(eng.params["groups"]["rec0"]["wx"]["w"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1


def test_full_width_builds_with_its_widths():
    """recurrentgemma-2b builds at its registered widths (a meta-device
    init): 8 groups of (rec, rec, attn) stacked, 2 tail blocks, MQA 10/1
    at head_dim 256, d_ff 7680, an untied 256000-wide unembedding; its
    cache 8 rings of 2048 and 18 recurrent states."""
    cfg = tget_config("recurrentgemma-2b")
    TT.check_supported(cfg)
    params = trg.init_hybrid(torch.Generator(), cfg, device="meta")
    g = params["groups"]
    assert g["rec0"]["wx"]["w"].shape == (8, 2560, 2560)
    assert g["attn2"]["wq"]["w"].shape == (8, 2560, 2560)
    assert g["attn2"]["wk"]["w"].shape == (8, 2560, 256)
    assert g["attn2"]["mlp"]["up"]["w"].shape == (8, 2560, 7680)
    assert len(params["tail"]) == 2 and params["unembed"]["w"].shape == (2560, 256000)
    c = trg.init_hybrid_cache(cfg, 1, 8, 8192, device="meta")
    assert c.k.shape == (8, 8, 2048, 1, 256) and c.h.shape == (18, 8, 2560)
    assert c.conv.shape == (18, 8, 3, 2560)


# ---------------------------------------------------------------------------
# head_dim 256 in the attention kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,S,window", [("tri", 160, None), ("band", 300, 100),
                                           ("dense", 130, None)])
def test_plain_flash_attention_head256_matches_pallas(kind, S, window):
    """The plain flash_attention at D = 256 on every schedule against the
    Pallas kernel in interpret mode: within rtol 1e-5 / atol 1e-4, the same
    block-step count as its counter and ``planned_grid_steps``."""
    rng = np.random.default_rng(S)
    BH = 2
    q, k, v = (rng.standard_normal((BH, S, D)).astype(np.float32) for _ in range(3))
    kw = dict(causal=True, window=window, skip_grid=kind != "dense")
    oj, sj = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 interpret=True, return_steps=True, **kw)
    ot, st = tfa.flash_attention(_t(q), _t(k), _t(v), return_steps=True, **kw)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL_K, atol=ATOL_K)
    assert int(st) == int(sj) == tfa.planned_grid_steps(BH, S, **kw)


def test_grouped_head256_mqa_entry_matches_flat():
    """The model-layout entry at recurrentgemma's MQA (10 query heads on 1
    kv head, window 2048 > S: plain causal) equals the flat entry on the
    kv head repeated to every head."""
    rng = np.random.default_rng(10)
    B, S, H = 1, 70, 10
    q = _t(rng.standard_normal((B, S, H, D)).astype(np.float32))
    k = _t(rng.standard_normal((B, S, 1, D)).astype(np.float32))
    v = _t(rng.standard_normal((B, S, 1, D)).astype(np.float32))
    og = tfa.flash_attention_grouped(q, k, v, causal=True, window=2048)
    flat = lambda t: t.transpose(1, 2).reshape(B * t.shape[2], S, D)
    of = tfa.flash_attention(flat(q), flat(k.repeat_interleave(H, 2)),
                             flat(v.repeat_interleave(H, 2)), causal=True)
    assert torch.equal(flat(og), of)


def test_plain_flash_decode_head256_group10_matches_pallas():
    """The bf16/f32-cache decode at D = 256 with a group of 10 over one kv
    head (two 8-row P.V blocks in the kernel, the second ragged): mixed
    lengths around the 128-row split width, a full ring, a freed slot of
    exact zeros."""
    rng = np.random.default_rng(256)
    B, T, KVr, G = 5, 260, 1, 10
    qg = rng.standard_normal((B, KVr, G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVr, D)).astype(np.float32)
    nvalid = np.array([129, 128, 260, 1, 77], np.int32)
    active = np.array([1, 1, 1, 1, 0], np.int32)
    oj = jfd.flash_decode(*map(jnp.asarray, (qg, k, v, nvalid, active)), interpret=True)
    ot = tfd.flash_decode(*map(_t, (qg, k, v, nvalid, active)))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), rtol=RTOL_K, atol=ATOL_K)
    assert (ot[4] == 0).all()


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on ``meta`` tensors (no card here): the
    sm_90 check passes, the decode split width is 128, the C entry points
    record their calls, and the plain versions raise if anything falls
    back to them."""
    calls = []

    def entry(fn):
        if fn == "flash_decode_split_width":
            return lambda d: 128

        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "entry", entry)
    for mod, name in ((tfa, "flash_attention_plain"), (tfa, "flash_attention_grouped_plain"),
                      (tfd, "flash_decode_plain"), (tfd, "flash_decode_quant_plain"),
                      (tfd, "_decode_plain")):
        monkeypatch.setattr(mod, name, no_fallback)
    return calls


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_head_dim_256_launches_both_kernels(fake_card, dtype):
    """recurrentgemma's shapes reach the C launchers with D = 256: prefill
    (10 heads over 1 kv head, window 2048 past S: band) and decode (B 8,
    G 10, a 2048 ring: a (8, 1, 16, 10, 260) partial scratch); the views
    pass the 16-byte rule at H * D = 2560 and KVr * D = 256."""
    before = dict(_build.launches)
    B, S, H = 1, 2500, 10
    out = tfa.flash_attention_grouped(_meta(B, S, H, D, dtype=dtype),
                                      _meta(B, S, 1, D, dtype=dtype),
                                      _meta(B, S, 1, D, dtype=dtype), causal=True, window=2048)
    assert out.shape == (B, S, H, D)
    qg = _meta(8, 1, 10, D, dtype=torch.float32)
    kv = _meta(8, 2048, 1, D, dtype=dtype)
    n = _meta(8, dtype=torch.int32)
    assert tfd.flash_decode(qg, kv, kv, n, n).shape == (8, 1, 10, D)
    (fa, fa_args), (fd, fd_args) = fake_card
    assert fa == "flash_attention_launch" and fd == "flash_decode_launch"
    assert fa_args[5:15] == (B, S, H, H, D, 128, 1, 2, 17, 2048)
    assert fd_args[7:12] == (8, 2048, 1, 10, D)
    assert _build.launches["flash_attention"] == before["flash_attention"] + 1
    assert _build.launches["flash_decode"] == before["flash_decode"] + 1
    for t, name in ((_meta(B, S, H * D).view(B, S, H, D), "q"),
                    (_meta(B, S, D).view(B, S, 1, D), "k")):
        assert tfa.tc_view_error(t, name) is None


def test_int8_decode_is_not_built_at_head_dim_256(fake_card):
    """No path reaches the int8 cache at D = 256 (the hybrid has none): its
    kernel is not instantiated there and the wrapper raises before a
    launch, with no fallback."""
    qg, n = _meta(2, 1, 10, D, dtype=torch.float32), _meta(2, dtype=torch.int32)
    k8, s8 = _meta(2, 64, 1, D, dtype=torch.int8), _meta(2, 64, 1, dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        tfd.flash_decode_quant(qg, k8, s8, k8, s8, n, n, 8)
    assert fake_card == []
    assert 256 in tfd.HEAD_DIMS and 256 not in tfd.QUANT_HEAD_DIMS


def test_smoke_config_is_the_reference_config():
    """The port's smoke config equals the reference's field for field."""
    assert dataclasses.asdict(tget_config(ARCH)) == dataclasses.asdict(jget_config(ARCH))


def test_quality_tap_leaves_the_hybrid_cache_as_it_found_it():
    """The logit-RMS probe restores what its two decode steps wrote on the
    hybrid's cache: each slot's ring row at its position (past the window:
    the wrapped row) and the whole h and conv fields; every field bit for
    bit after it."""
    from repro_torch.obs.quality import lm_logit_rms_probe

    _, _, tm, tp = _models("float32", "axq8")
    cache = tm.init_cache(1, 2, 64)
    rng = np.random.default_rng(3)
    tm.prefill(tp, cache, _t(rng.integers(0, 512, 45)).long(), 0)
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
    bf16.py's tolerances: ``hybrid_forward``'s logits past the window, and
    every cache field after ``hybrid_prefill_batch`` (three rows in a
    48-token bucket, past the window)."""
    jm, jp, tm, tp = _models("bfloat16", approx)
    jdeg, tdeg = P.degrees(degree)
    toks = np.random.default_rng(6).integers(0, 512, (2, 40)).astype(np.int32)
    lens, slots = [48, 17, 3], [2, 0, 1]
    _, btoks = P.padded_rows(lens, 48, 8)
    with P.jax_backend("pallas"):
        lj, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(
            jp, {"tokens": jnp.asarray(toks)}, jdeg)
        jc = jax.jit(jm.prefill_batch)(jp, jm.init_cache(tp=1, batch=3, max_len=64),
                                       jnp.asarray(btoks), jnp.asarray(slots),
                                       jnp.asarray(lens), degree=jdeg)
    lt, _ = tm.forward(tp, {"tokens": _t(toks).long()}, degree=tdeg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=LOGIT_ATOL_BF16)
    tc = tm.prefill_batch(tp, tm.init_cache(1, 3, 64), _t(btoks).long(), slots, lens,
                          degree=tdeg)
    for f in ("k", "v", "h", "conv"):
        assert _rel(_np(getattr(tc, f)), _np(getattr(jc, f))) <= CACHE_REL_BF16, f
