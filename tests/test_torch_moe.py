"""Port parity of the MoE family (``repro_torch.models.moe`` and its wiring
through the transformer, the packs, the registry, the LM adapter and the
engine) against the JAX package, at granite-moe-3b-a800m-smoke and
qwen2-moe-a2.7b-smoke (shared experts, QKV bias) in f32, on numpy-seeded
inputs; and the expert-batched GEMM launches (``axqmm_experts`` /
``axqmm_gated_experts``) on the CPU: their plain versions against the
reference's ``vmap`` of ``axq_matmul`` / ``axq_gated``, and their launch
path on ``meta`` tensors (no card here).

Tolerances.  Routing is compared for equality: the top-k expert ids, the
capacity and the dispatched ``(E, C, d)`` buffer (the same rows in the same
slots: the same keep mask), bit for bit.  ``moe_apply``'s output within
1e-5 abs (f32: the router and expert products sum in another order than
XLA's), the models' logits and cache rows within 1e-4 in f32
(tests/test_torch_models.py) and at the bf16 tolerances of
tests/test_torch_models_bf16.py, the engines' greedy streams equal up to
near-ties below LOGIT_TOL (tests/test_torch_serve.py).  The batched plain
GEMMs are bit-identical to the reference's xla route where no activation
runs (``down``; the gated product under ``relu``); under ``silu`` / ``gelu``
the two frameworks' activations differ in the last f32 ulp, and the
reference's Pallas kernels in interpret mode fold their f32 sums in
another contraction, so those are held to GEMM_ATOL (the 2-D gap of
tests/test_torch_kernels.py, at the scale of these outputs)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import get_config as jget_config
from repro.core.approx import ApproxMode as JMode
from repro.core.approx import ApproxPolicy as JPolicy
from repro.core.approx import ApproxSpec as JSpec
from repro.core.dynamic import QoSController as JQoS
from repro.kernels import dispatch as jdispatch
from repro.kernels.qstore import prepack_params as jprepack_params
from repro.kernels.qstore import prepack_weight as jprepack
from repro.models import moe as jmoe
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import _build
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.kernels.qstore import PackedQWeight, prepack_params
from repro_torch.models import build_model
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as TT
from repro_torch.models.transformer import LMCacheQ
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import LMAdapter, ServeEngine

torch.set_num_threads(2)

ATOL_MOE = 1e-5
ATOL_LOGITS = 1e-4
LOGIT_ATOL_BF16, CACHE_REL_BF16 = 0.25, 3e-2
GEMM_ATOL = 1e-5
LOGIT_TOL = 1e-2
SMS = 132
GRANITE, QWEN = "granite-moe-3b-a800m-smoke", "qwen2-moe-a2.7b-smoke"
ARCHS = (GRANITE, QWEN)


def _cfgs(arch, **moe_kw):
    """(jax cfg, port cfg) in f32, MoE fields ``moe_kw`` replaced."""
    out = []
    for get in (jget_config, tget_config):
        c = dataclasses.replace(get(arch), dtype="float32")
        if moe_kw:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_kw))
        out.append(c)
    return out


def _policies(kind):
    """(jax policy, port policy): exact, or AXQ-8 with a dynamic degree on
    the experts and the shared experts."""
    if kind == "exact":
        return JPolicy(), ApproxPolicy()
    return (JPolicy(default=JSpec(mode=JMode.AXQ, ebits=8, block=64, dynamic=True)),
            ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8, block=64,
                                            dynamic=True)))


@functools.lru_cache(maxsize=None)
def _moe_params(arch):
    """One MoE layer's reference params (numpy) from a fixed key."""
    jcfg, _ = _cfgs(arch)
    return jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(3), jcfg, 1))


class _Recorder:
    """Routing seen inside the reference's ``moe_apply`` (under jit and
    shard_map, through ``jax.debug.callback``): top-k ids and the
    dispatched ``(E, C, d)`` buffer."""

    def __init__(self, monkeypatch):
        self.ids, self.bufs = [], []
        top_k, ffn = jax.lax.top_k, jmoe._local_expert_ffn

        def rec_top_k(x, k):
            v, i = top_k(x, k)
            jax.debug.callback(lambda a: self.ids.append(np.asarray(a)), i)
            return v, i

        def rec_ffn(w, buf, *a, **kw):
            jax.debug.callback(lambda b: self.bufs.append(np.asarray(b)), buf)
            return ffn(w, buf, *a, **kw)

        monkeypatch.setattr(jax.lax, "top_k", rec_top_k)
        monkeypatch.setattr(jmoe, "_local_expert_ffn", rec_ffn)


def _port_routing(monkeypatch):
    bufs = []
    ffn = tmoe._local_expert_ffn

    def rec(w, buf, *a, **kw):
        bufs.append(buf.clone())
        return ffn(w, buf, *a, **kw)

    monkeypatch.setattr(tmoe, "_local_expert_ffn", rec)
    return bufs


MOE_CASES = [
    # (arch, spec, degree, shape (B, S), packed, capacity_factor)
    (GRANITE, "exact", None, (2, 12), False, None),
    (GRANITE, "axq", None, (2, 12), True, None),
    (GRANITE, "axq", 6, (2, 12), True, None),
    (GRANITE, "axq", "vector", (2, 12), True, None),
    (GRANITE, "axq", 5, (2, 12), False, None),          # float experts: on-the-fly packs
    (GRANITE, "axq", 6, (1, 64), True, 0.05),           # drops: C at its floor of 4
    (GRANITE, "exact", None, (8, 1), False, None),      # a decode tick, free slots counted
    (QWEN, "exact", None, (2, 12), False, None),
    (QWEN, "axq", 6, (2, 12), True, None),
    (QWEN, "axq", "vector", (1, 64), True, 0.05),
    (QWEN, "axq", 7, (8, 1), True, None),
]


@pytest.mark.parametrize("arch,spec,degree,shape,packed,cf", MOE_CASES)
def test_moe_apply_routing_and_output_match_reference(monkeypatch, arch, spec, degree, shape,
                                                      packed, cf):
    """``moe_apply`` on the same h: the top-k ids, the capacity and the
    dispatched buffer (so the keep mask) equal the reference's, the output
    within 1e-5 and the aux loss within 1e-6.  ``vector`` passes one entry
    of a per-site (n_layers + 1,) degree vector, as the layer loop does; a
    decode-shaped call (8 slots, one token each) counts every slot in the
    capacity."""
    jcfg, tcfg = _cfgs(arch, **({} if cf is None else {"capacity_factor": cf}))
    jpol, tpol = _policies(spec)
    jp = _moe_params(arch)
    if packed:
        espec = jmoe.expert_spec(jpol, "layer/moe")
        jp = {**jp, "experts": {k: jprepack(jnp.asarray(w), espec.block)
                                for k, w in jp["experts"].items()}}
        jp = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(jp)
    assert isinstance(tp["experts"]["up"], PackedQWeight) == packed
    rng = np.random.default_rng(sum(shape) + (degree if isinstance(degree, int) else 0))
    x = rng.standard_normal((*shape, jcfg.d_model)).astype(np.float32)
    if degree == "vector":
        jdeg, tdeg = jnp.asarray([8, 6, 5], jnp.int32)[1], torch.tensor([8, 6, 5],
                                                                         dtype=torch.int32)[1]
    elif degree is None:
        jdeg, tdeg = None, None
    else:
        jdeg, tdeg = jnp.int32(degree), torch.tensor(degree, dtype=torch.int32)

    rec = _Recorder(monkeypatch)
    with P.jax_backend("xla"):
        fn = jax.jit(lambda p, h, d: jmoe.moe_apply(p, h, jcfg, jpol, "layer/moe", d))
        yj, aj = fn(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jdeg)
        jax.effects_barrier()
    bufs = _port_routing(monkeypatch)
    yt, at = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg, tpol, "layer/moe", tdeg)

    B, S = shape
    t = B * S
    C = tmoe.capacity(tcfg, t)
    _, ids, _ = tmoe.route(tp["router"]["w"], torch.from_numpy(x).reshape(t, -1), tcfg)
    (jids,), (jbuf,), (tbuf,) = rec.ids, rec.bufs, bufs
    np.testing.assert_array_equal(ids.numpy(), jids)
    assert jbuf.shape == tuple(tbuf.shape) == (tcfg.moe.n_experts, C, tcfg.d_model)
    np.testing.assert_array_equal(tbuf.numpy(), jbuf)
    _, _, keep = tmoe.dispatch_plan(ids, C, tcfg.moe.n_experts)
    kept = np.bincount(ids.reshape(-1)[keep].numpy(), minlength=tcfg.moe.n_experts)
    np.testing.assert_array_equal(kept, (np.abs(jbuf).sum(-1) > 0).sum(-1))
    if cf is not None:
        assert C == 4 and not bool(keep.all())
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=ATOL_MOE)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)


def test_capacity_copies_the_reference_formula():
    """The capacity at the serving shapes: granite's 8 decode slots give 4,
    an exact-length prefill of 512 tokens 128; qwen2-moe's 8 slots 4, a
    255-token prefill 22 and a 512-token one 43."""
    g, q = tget_config("granite-moe-3b-a800m"), tget_config("qwen2-moe-a2.7b")
    assert [tmoe.capacity(g, t) for t in (8, 512, 64)] == [4, 128, 16]
    assert [tmoe.capacity(q, t) for t in (8, 255)] == [4, 22]
    assert tmoe.capacity(q, 512) == 43


def test_moe_int8_lever_and_ring_lever(monkeypatch):
    """REPRO_MOE_INT8 promotes an EXACT expert spec to AXQ-8 on both sides
    (and the prepack then packs the experts); REPRO_RING_TP's ring combine
    is the identity on one device, as the reference's ring is on a 1-wide
    model axis (tests/test_torch_tp_moe.py holds it on a mesh)."""
    monkeypatch.setattr(jmoe, "_MOE_INT8", True)
    monkeypatch.setattr(tmoe, "_MOE_INT8", True)
    js, ts = jmoe.expert_spec(JPolicy(), "layer/moe"), tmoe.expert_spec(ApproxPolicy(),
                                                                        "layer/moe")
    assert (js.mode.value, js.ebits, js.block) == (ts.mode.value, ts.ebits, ts.block) == \
        ("axq", 8, 256)
    _, tcfg = _cfgs(GRANITE)
    params = TT.init_lm(torch.Generator().manual_seed(0), tcfg)
    packed = prepack_params(params, tcfg, ApproxPolicy())
    assert isinstance(packed["layers"]["moe"]["experts"]["down"], PackedQWeight)
    assert isinstance(packed["layers"]["wq"]["w"], torch.Tensor)
    x = torch.randn((1, 4, tcfg.d_model), generator=torch.Generator().manual_seed(1))
    lp = TT.layer_params(params["layers"], 0)["moe"]
    want = tmoe.moe_apply(lp, x, tcfg, ApproxPolicy(), "layer/moe")
    monkeypatch.setattr(tmoe, "_MOE_RING", True)
    got = tmoe.moe_apply(lp, x, tcfg, ApproxPolicy(), "layer/moe")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the expert-batched GEMMs' plain versions
# ---------------------------------------------------------------------------


def _expert_weights(E, K, N, block, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((E, K, N)).astype(np.float32) / np.sqrt(K) for _ in range(2)]
    jps = [jprepack(jnp.asarray(w), block) for w in ws]
    return jps, [params_from_numpy(jax.tree.map(np.asarray, {"w": p}))["w"] for p in jps]


@pytest.mark.parametrize("route", ["xla", "pallas"])
@pytest.mark.parametrize("act", ["relu", "silu", "gelu"])
def test_batched_plain_gemms_match_vmapped_reference(route, act):
    """``axqmm_gated_experts_plain`` / ``axqmm_experts_plain`` against the
    reference's ``vmap`` of ``axq_gated`` / ``axq_matmul`` over packed
    experts (E 5, C 6 with two all-zero capacity rows, ragged N 72), at
    ebits 8, 5 and 1; the xla route without an activation bit for bit,
    the others within GEMM_ATOL; each expert's slice bit for bit the 2-D
    plain version on it."""
    E, C, K, N, bk = 5, 6, 128, 72, 64
    (ju, jg), (tu, tg) = _expert_weights(E, K, N, bk, 11)
    x = np.random.default_rng(12).standard_normal((E, C, K)).astype(np.float32)
    x[:, -2:] = 0.0
    worst = 0.0
    for e in (8, 5, 1):
        with P.jax_backend(route):
            gj = jax.vmap(lambda xe, u, g: jdispatch.axq_gated(
                xe, u, g, act=act, block=bk, ebits=e, ste=True))(jnp.asarray(x), ju, jg)
            dj = jax.vmap(lambda xe, w: jdispatch.axq_matmul(
                xe, w, block=bk, ebits=e, ste=True))(jnp.asarray(x[..., :K]), ju)
        gt = taxq.axqmm_gated_experts_plain(torch.from_numpy(x), tu, tg, e, act=act)
        dt = taxq.axqmm_experts_plain(torch.from_numpy(x), tu, e)
        for ref, port, exact in ((gj, gt, route == "xla" and act == "relu"),
                                 (dj, dt, route == "xla")):
            if exact:
                np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
            np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0, atol=GEMM_ATOL)
            worst = max(worst, float(np.abs(port.numpy() - np.asarray(ref)).max()))
        assert (gt[:, -2:] == 0).all() and (dt[:, -2:] == 0).all()
        for i in range(E):
            xi = torch.from_numpy(x[i])
            assert torch.equal(gt[i], taxq.axqmm_gated_plain(
                xi, taxq.expert_pack(tu, i), taxq.expert_pack(tg, i), e, act=act))
            assert torch.equal(dt[i], taxq.axqmm_packed_plain(xi, taxq.expert_pack(tu, i), e))
    print(f"largest |port - reference| on the {route} route under {act}: {worst:.3g}")


def test_batched_routers_float_weights_and_backward():
    """The float-weight routers pack on the fly (equal to the packed
    route) and differentiate per expert like the 2-D routers, straight
    through and through the oracle."""
    E, C, K, N, bk = 3, 4, 128, 64, 64
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((E, C, K)).astype(np.float32))
    wu, wg = (torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32) / 8)
              for _ in range(2))
    pu, pg = (taxq.prepack_weight(w, bk) for w in (wu, wg))
    assert torch.equal(tdispatch.axq_gated_experts(x, wu, wg, block=bk, ebits=6),
                       tdispatch.axq_gated_experts(x, pu, pg, block=bk, ebits=6))
    assert torch.equal(tdispatch.axq_matmul_experts(x, wu, block=bk, ebits=6),
                       tdispatch.axq_matmul_experts(x, pu, block=bk, ebits=6))
    for ste in (True, False):
        leaves = [t.clone().requires_grad_() for t in (x, wu, wg)]
        tdispatch.axq_gated_experts(*leaves, block=bk, ebits=6, ste=ste).sum().backward()
        for i in range(E):
            ref = [t[i].detach().clone().requires_grad_() for t in (x, wu, wg)]
            tdispatch.axq_gated(*ref, block=bk, ebits=6, ste=ste).sum().backward()
            for a, b in zip(leaves, ref):
                assert torch.equal(a.grad[i], b.grad)
        xl, wl = x.clone().requires_grad_(), wu.clone().requires_grad_()
        tdispatch.axq_matmul_experts(xl, wl, block=bk, ebits=6, ste=ste).sum().backward()
        xr, wr = x[1].clone().requires_grad_(), wu[1].clone().requires_grad_()
        tdispatch.axq_matmul(xr, wr, block=bk, ebits=6, ste=ste).sum().backward()
        assert torch.equal(xl.grad[1], xr.grad) and torch.equal(wl.grad[1], wr.grad)


# ---------------------------------------------------------------------------
# the launch path on meta tensors
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path on ``meta`` tensors: the sm_90 check
    passes, the card has 132 SMs, the launchers record their calls and
    every scratch, and the plain versions raise if anything falls back."""
    calls, scratches = [], []

    def entry(fn):
        def launch(*args):
            calls.append((fn, args))
            return 0
        return launch

    def no_fallback(*a, **kw):
        raise AssertionError("a kernel call fell back to the plain version")

    real_scratch = taxq._scratch

    def scratch(*a, **kw):
        s = real_scratch(*a, **kw)
        scratches.append(s)
        return s

    monkeypatch.setattr(_build, "require_sm90", lambda t: None)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "sm_count", lambda t: SMS)
    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(taxq, "_scratch", scratch)
    for name in ("axqmm_experts_plain", "axqmm_gated_experts_plain", "qmm_packed_ref",
                 "qmm_gated_packed_ref"):
        monkeypatch.setattr(taxq, name, no_fallback)
    return calls, scratches


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_pack(E, N, K, bk):
    return PackedQWeight(_meta(E, N, K, dtype=torch.int8), _meta(E, N, K // bk))


@pytest.mark.parametrize("E,C,N,K,bk,gated", [
    (40, 4, 512, 1536, 256, True), (40, 4, 1536, 512, 256, False),      # granite decode
    (40, 128, 512, 1536, 256, True), (40, 128, 1536, 512, 256, False),  # 512-token prefill
    (60, 4, 1408, 2048, 256, True), (60, 4, 2048, 1408, 128, False),    # qwen2-moe decode
    (60, 43, 1408, 2048, 256, True), (60, 43, 2048, 1408, 128, False),
    (2, 4, 64, 4096, 256, True), (3, 2048, 256, 1024, 256, False)])     # split; pre-pass
def test_expert_batched_launch_hands_the_kernel_e_and_its_plan(fake_card, E, C, N, K, bk,
                                                               gated):
    """One launch for the E experts, with (E, C, N, K, bk[, act], cfg,
    n_split, part) after the pointers; the plan counts every expert's tiles
    (granite's decode: 1280 or 3840 one-warp blocks, no split); a split or
    pre-degraded plan gets one scratch an expert on a leading axis."""
    calls, scratches = fake_card
    before = dict(_build.launches)
    qx, sx = _meta(E, C, K, dtype=torch.int8), _meta(E, C, K // bk)
    if gated:
        out = taxq.axqmm_gated_experts_quantized(qx, sx, _meta_pack(E, N, K, bk),
                                                 _meta_pack(E, N, K, bk), 6)
    else:
        out = taxq.axqmm_experts_quantized(qx, sx, _meta_pack(E, N, K, bk), 6)
    assert out.shape == (E, C, N) and out.dtype == torch.float32
    p = taxq.plan(C, N, K, bk, gated, SMS, E)
    (fn, args), = calls
    name = "axqmm_gated_experts" if gated else "axqmm_experts"
    assert fn == name + "_launch"
    n_ptr = 9 if gated else 7
    assert args[n_ptr:n_ptr + 5] == (E, C, N, K, bk)
    assert args[-4:-1] == tuple(p)
    (s,) = scratches
    g = 2 if gated else 1
    if p.n_split > 1:
        assert s.shape == (E, g, K // bk * p.part, C, N) and s.dtype == torch.int32
    elif p.cfg == taxq.TILE_LARGE and C >= taxq.PREDEGRADE_M:
        assert s.shape == (E, (C + g * N) * K) and s.dtype == torch.int8
    else:
        assert s is None and args[n_ptr - 1] is None
    if C <= taxq.DECODE_M and E >= 40:
        assert p == taxq.Plan(taxq.DECODE)
        assert taxq.blocks(p, C, N, gated, E) == E * N // 16 >= 2 * SMS
    assert _build.launches[name] == before[name] + 1
    assert sum(_build.launches.values()) == sum(before.values()) + 1


def test_plan_counts_every_experts_tiles():
    """plan(..., experts) is the 2-D plan of a call with E times the tiles:
    one expert's decode at granite's gated shape would split K, 40 do not;
    a 43-row prefill takes 128-row tiles once the experts fill the card."""
    assert taxq.plan(4, 512, 1536, 256, True, SMS) == taxq.plan(4, 512, 1536, 256, True,
                                                                  SMS, 1)
    assert taxq.plan(4, 512, 1536, 256, True, SMS).n_split > 1
    assert taxq.plan(4, 512, 1536, 256, True, SMS, 40) == taxq.Plan(taxq.DECODE)
    assert taxq.plan(43, 1408, 2048, 256, True, SMS).cfg == taxq.TILE_SMALL
    assert taxq.plan(43, 1408, 2048, 256, True, SMS, 60) == taxq.Plan(taxq.TILE_LARGE)
    assert taxq.blocks(taxq.Plan(taxq.TILE_LARGE), 43, 1408, True, 60) == 22 * 60


@pytest.mark.parametrize("bad", ["experts", "shape", "block", "x_rank", "pair"])
def test_bad_expert_pack_raises_without_fallback(fake_card, bad):
    """A pack whose leading E, (N, K) or block disagrees with x, an x that
    is not (E, C, K), and an up/gate pair that disagrees all raise before
    any launch, and never run the plain version instead."""
    calls, _ = fake_card
    E, C, N, K, bk = 4, 4, 64, 256, 128
    before = dict(_build.launches)
    qx, sx = _meta(E, C, K, dtype=torch.int8), _meta(E, C, K // bk)
    pw = {"experts": _meta_pack(E + 1, N, K, bk), "shape": _meta_pack(E, N, K // 2, bk),
          "block": _meta_pack(E, N, K, 32), "x_rank": _meta_pack(E, N, K, bk),
          "pair": _meta_pack(E, N, K, bk)}[bad]
    if bad == "x_rank":
        qx = _meta(E * C, K, dtype=torch.int8)
    with pytest.raises(ValueError):
        if bad == "pair":
            taxq.axqmm_gated_experts_quantized(qx, sx, pw, _meta_pack(E, 2 * N, K, bk), 8)
        else:
            taxq.axqmm_experts_quantized(qx, sx, pw, 8)
    with pytest.raises(ValueError):
        taxq.axqmm_gated_experts_quantized(qx, sx, pw, _meta_pack(E, 2 * N, K, bk)
                                           if bad == "pair" else pw, 8)
    assert calls == []
    assert _build.launches == before


# ---------------------------------------------------------------------------
# packs, models, engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_packs_through_convert_match_prepack(arch):
    """The reference's packed MoE tree through ``params_from_numpy``
    equals the port's ``prepack_params`` of the converted float tree, bit
    for bit: the experts per (layer, expert) slice with leading (L, E), the
    shared experts (qwen2-moe) per their own spec; the router stays f32."""
    jm, jp_packed, _, tp_packed = P.models("float32", "axq8", arch=arch)
    jp = jm.init(jax.random.PRNGKey(0), tp=1)
    _, tcfg = _cfgs(arch)
    tp = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), tcfg,
                        ApproxPolicy(default=ApproxSpec(mode=ApproxMode.AXQ, ebits=8,
                                                        dynamic=True)))
    a, b = tp_packed["layers"]["moe"], tp["layers"]["moe"]
    L, E = tcfg.n_layers, tcfg.moe.n_experts
    for k in ("up", "gate", "down"):
        pa, pb = a["experts"][k], b["experts"][k]
        assert isinstance(pa, PackedQWeight) and pa.qw.shape[:2] == (L, E)
        assert torch.equal(pa.qw, pb.qw) and torch.equal(pa.scales, pb.scales)
        if "shared" in a:
            assert torch.equal(a["shared"][k].qw, b["shared"][k].qw)
            assert torch.equal(a["shared"][k].scales, b["shared"][k].scales)
    assert ("shared" in a) == (arch == QWEN)
    assert torch.equal(a["router"]["w"], b["router"]["w"])
    assert a["router"]["w"].dtype == torch.float32 and a["router"]["w"].shape == (
        L, tcfg.d_model, E)
    jpk = jprepack_params(jp, jget_config(arch), jm.policy)
    assert np.array_equal(np.asarray(jpk["layers"]["moe"]["experts"]["up"].qw),
                          a["experts"]["up"].qw.numpy())


@pytest.mark.parametrize("arch,approx,degree", [
    (GRANITE, "exact", None), (GRANITE, "axq8", 6), (GRANITE, "axq8", "vector"),
    (QWEN, "exact", None), (QWEN, "axq8", 6), (QWEN, "axq8", "vector")])
def test_prefill_decode_match_reference(arch, approx, degree):
    """``lm_prefill`` then ``lm_decode_step`` (slot 0 free) in f32 on an f32
    cache: logits and the live cache rows within 1e-4 of the reference's
    Pallas route."""
    prefill, decode = P.run_prefill_decode("float32", approx, degree, "pallas",
                                           cache_dtype=jnp.float32, arch=arch)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL_LOGITS, err_msg=name)


@pytest.mark.parametrize("arch,approx,degree", [(GRANITE, "axq8", 6), (QWEN, "exact", None),
                                                (QWEN, "axq8", "vector")])
def test_prefill_decode_bf16_match_reference(arch, approx, degree):
    """The same in bf16 on the bf16 cache, at tests/test_torch_models_bf16.py's
    tolerances."""
    prefill, decode = P.run_prefill_decode("bfloat16", approx, degree, "pallas", arch=arch)
    for stage in (prefill, decode):
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("k", "v"):
            ref, port = stage[name]
            assert np.linalg.norm(port - ref) / max(np.linalg.norm(ref), 1e-30) <= \
                CACHE_REL_BF16


def test_lm_forward_aux_matches_reference():
    """``lm_forward``'s logits (1e-4) and the summed aux loss of the
    layers (1e-6) on granite-smoke under axq8 at degree 6."""
    jm, jp, tm, tp = P.models("float32", "axq8", arch=GRANITE)
    toks = np.random.default_rng(4).integers(0, 512, (2, 10)).astype(np.int32)
    with P.jax_backend("xla"):
        lj, aj = jax.jit(lambda p, b: jm.forward(p, b, degree=jnp.int32(6)))(
            jp, {"tokens": jnp.asarray(toks)})
    lt, at = tm.forward(tp, {"tokens": torch.from_numpy(toks).long()},
                        degree=torch.tensor(6, dtype=torch.int32))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=ATOL_LOGITS)
    np.testing.assert_allclose(float(at), float(aj), rtol=0, atol=1e-6)
    assert float(at) > 0


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


@pytest.mark.parametrize("arch,quant", [(GRANITE, False), (GRANITE, True), (QWEN, False)],
                         ids=["granite-bf16-cache", "granite-int8-cache", "qwen-bf16-cache"])
def test_engine_streams_match_reference(arch, quant, monkeypatch):
    """Five requests on two slots in f32 under axq8 with the QoS ladder
    8 -> 6, exact-length admission (asked for buckets and packing, which
    both engines drop for MoE): the port's greedy streams equal the JAX
    engine's on its Pallas route, and the degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    from repro.serve.admission import AdmissionConfig as JAdmissionConfig

    jm, jp, tm, tp = P.models("float32", "axq8", arch=arch)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in (5, 9, 14, 3, 11)]
    with P.jax_backend("pallas"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=JQoS(**_ladder()),
                            admission=JAdmissionConfig(pack=2), emitter=False)
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    teng = ServeEngine(tm, tp, slots=2, max_len=32, qos=TQoS(**_ladder()),
                       admission=AdmissionConfig(pack=2), emitter=False)
    assert isinstance(teng.cache, LMCacheQ) == quant
    assert teng.workload.admission is None
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 5) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 5, LOGIT_TOL)
    assert teng.workload.trace_counts["prefill_batch"] == 0
    jdeg = [d for _, d in jeng.stats.degree_history]
    tdeg = [d for _, d in teng.stats.degree_history]
    assert tdeg == jdeg, (tdeg, jdeg)
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


def test_adapter_and_registry_keep_moe_exact_length():
    """The LM adapter drops bucketed / packed / chunked admission for MoE;
    the model's prefill_batch and the transformer's batch and chunk
    prefills raise; chunked prefill is not offered."""
    _, tcfg = _cfgs(GRANITE)
    model = build_model(tcfg, device="cpu")
    ad = LMAdapter(model, max_len=64, admission=AdmissionConfig(pack=4, chunk_tokens=16))
    assert ad.admission is None and not ad._chunk_ok
    assert not model.supports_chunked_prefill()
    params = model.init(seed=0)
    cache = model.init_cache(1, 2, 16, quant=False)
    toks = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        model.prefill_batch(params, cache, toks, [0, 1], [8, 8])
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        TT.lm_prefill_batch(params, tcfg, model.policy, cache, toks, [0, 1], [8, 8])
    with pytest.raises(ValueError, match="exact-length only for MoE"):
        TT.lm_prefill_chunk(params, tcfg, model.policy, cache, toks[0], 0, 0, 8)
    with pytest.raises(ValueError, match="chunked prefill unsupported"):
        model.prefill_chunk(params, cache, toks[0], 0, 0, 8)


@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge", "internvl2-1b-smoke",
                                  "hubert-xlarge-smoke"])
def test_check_supported_admits_frontend_families(arch):
    """The frontend families are ported: ``check_supported``,
    ``build_model`` and ``prepack_params`` admit them, and each builds its
    frontend projections (``v_proj`` fc1 / fc2, ``a_proj`` fc1, with
    biases) at its registered widths (a meta device init: no weights
    made); a config whose frontend does not match its family is refused."""
    import dataclasses

    cfg = tget_config(arch)
    TT.check_supported(cfg)
    build_model(cfg, device="cpu")
    params = TT.init_lm(torch.Generator(), cfg, device="meta")
    d, fd = cfg.d_model, cfg.frontend_dim
    if cfg.frontend == "vision":
        assert params["v_proj"]["fc1"]["w"].shape == (fd, d)
        assert params["v_proj"]["fc2"]["w"].shape == (d, d)
        assert params["v_proj"]["fc2"]["b"].shape == (d,)
        assert "a_proj" not in params
    else:
        assert params["a_proj"]["fc1"]["w"].shape == (fd, d)
        assert params["a_proj"]["fc1"]["b"].shape == (d,)
        assert "v_proj" not in params and not cfg.causal
    assert params["unembed"]["w"].shape == (d, cfg.padded(1).vocab)
    if not arch.endswith("-smoke"):
        packed = prepack_params(TT.init_lm(torch.Generator(), tget_config(arch + "-smoke")),
                                tget_config(arch + "-smoke"), ApproxPolicy())
        assert ("v_proj" in packed) == (cfg.frontend == "vision")
    with pytest.raises(NotImplementedError):
        TT.check_supported(dataclasses.replace(cfg, frontend=None))


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b"])
def test_moe_archs_build_with_their_full_widths(arch):
    """The two MoE archs build (no weights made: a meta device init) with
    their registered widths: the stacked expert tree's shapes."""
    cfg = tget_config(arch)
    TT.check_supported(cfg)
    params = TT.init_lm(torch.Generator(), cfg, device="meta")
    m, L, d = cfg.moe, cfg.n_layers, cfg.d_model
    moe = params["layers"]["moe"]
    assert moe["router"]["w"].shape == (L, d, m.n_experts)
    assert moe["experts"]["up"].shape == (L, m.n_experts, d, m.d_expert)
    assert moe["experts"]["down"].shape == (L, m.n_experts, m.d_expert, d)
    assert ("shared" in moe) == bool(m.n_shared)
    assert "mlp" not in params["layers"]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_launch_serve_moe_under_qos(monkeypatch, quant):
    """``launch.serve --arch granite-moe-3b-a800m-smoke --approx axq8
    --qos`` on the CPU, on either cache (buckets and packing asked for and
    dropped): every request finishes with its tokens through exact-length
    prefills, and the ladder moves."""
    from repro_torch.launch import serve as launch_serve

    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    s, eng = launch_serve.run(["--arch", GRANITE, "--device", "cpu", "--approx", "axq8",
                               "--qos", "--requests", "6", "--new-tokens", "5",
                               "--prefill-buckets", "auto", "--pack", "4"])
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert isinstance(eng.cache, LMCacheQ) == quant
    assert eng.workload.admission is None and eng.stats.prefill_calls > 0
    assert isinstance(eng.params["layers"]["moe"]["experts"]["up"], PackedQWeight)
    assert len({d for _, d in eng.stats.degree_history}) > 1
