"""Port parity of the frontend archs: internvl2-1b-smoke (the VLM: patch
embeddings through ``v_proj`` fc1, gelu, fc2, prepended to the tokens) and
hubert-xlarge-smoke (the audio encoder: frame features through
``a_proj/fc1`` plus sinusoidal positions, non-causal ``dense`` attention,
no rope, no decode step), each built in the JAX reference from a seed and
converted through numpy, run through the reference's Pallas route
(interpret mode on the CPU) and the port's plain versions.

Tolerances (the repo's): f32 logits and ``embed_inputs`` 1e-4 absolute,
the loss rtol 1e-5, ``train_step`` as tests/_torch_train.py holds it (one
step rtol 1e-5, three steps params atol 1e-4), the packs bit for bit, bf16
logits 0.25 absolute (tests/test_torch_models_bf16.py's gate), engine
streams equal up to near-ties below 1e-2 (tests/_torch_parity.py).
``_sinusoidal``: ``jnp.power`` and ``torch.pow`` differ by one f32 ulp on
some frequencies, so the angles agree within 2 ulps and the table within
2 ulps of its angle plus 2 of its value; after a train step the entries
whose gradient is near AdamW's eps, where the update is ill-conditioned,
within Adam's step bound (ROADMAP §C)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
import _torch_train as TT
from repro.configs import get_config as jget_config
from repro.core.dynamic import QoSController as JQoS
from repro.models import registry as jregistry
from repro.models import transformer as JT
from repro.serve.admission import AdmissionConfig as JAdmissionConfig
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels.qstore import PackedQWeight, prepack_params
from repro_torch.models import build_model
from repro_torch.models import registry as tregistry
from repro_torch.models import transformer as TM
from repro_torch.models.transformer import LMCacheQ
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine
from repro_torch.tree import tree_leaves
from repro_torch.tune.plan import site_names, uniform_plan

torch.set_num_threads(2)

VLM, AUDIO = "internvl2-1b-smoke", "hubert-xlarge-smoke"
ARCHS = [VLM, AUDIO]
ATOL = 1e-4
LOGIT_ATOL_BF16 = 0.25
LOGIT_TOL = 1e-2
DEGREES = [("exact", None), ("axq8", 8), ("axq8", 6), ("axq8", "vector")]


def _batch(cfg, B=2, S=16, seed=0):
    """(jax batch, port batch) of one numpy draw: the frontend's features,
    the VLM's tokens, labels with some ignored (-1) entries."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, ::5] = -1
    b = {"labels": labels}
    if cfg.frontend == "audio":
        b["frame_feats"] = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    else:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
          for k, v in b.items()}
    return jb, tb


def _degrees(kind, cfg):
    if kind == "vector":
        vals = [(8, 6, 7, 5)[i % 4] for i in range(cfg.n_layers + 1)]
        return jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    return P.degrees(kind)


# ---------------------------------------------------------------------------
# the frontend pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,d", [(8, 32), (16, 64), (1024, 1280), (4096, 512)])
def test_sinusoidal_within_two_ulps(S, d):
    """The (S, d) table, ``[sin | cos]`` halves: the angles within 2 f32
    ulps of the reference's, the table within 2 ulps of its angle plus 2
    of its own value."""
    ref = np.asarray(JT._sinusoidal(S, d))
    got = TM._sinusoidal(S, d).numpy()
    assert got.shape == ref.shape == (S, d) and got.dtype == np.float32
    pos = np.arange(S, dtype=np.float32)[:, None]
    jfreq = np.asarray(jnp.power(10_000.0, 2 * jnp.arange(d // 2, dtype=jnp.float32) / d))
    tfreq = torch.pow(10_000.0, 2 * torch.arange(d // 2, dtype=torch.float32) / d).numpy()
    assert np.all(np.abs(jfreq - tfreq) <= 2 * np.spacing(jfreq))
    ang = pos / jfreq[None]
    bound = 2 * np.spacing(np.concatenate([ang, ang], -1)) + 2 * np.spacing(np.abs(ref))
    assert np.all(np.abs(got - ref) <= bound)
    # the halves are sin then cos, not interleaved
    np.testing.assert_allclose(got[:, 0], np.sin(np.arange(S, dtype=np.float32)), atol=1e-6)
    np.testing.assert_allclose(got[:, d // 2], np.cos(np.arange(S, dtype=np.float32)),
                               atol=1e-6)


@pytest.mark.parametrize("approx,degree", DEGREES[:3], ids=["exact", "axq8-8", "axq8-6"])
@pytest.mark.parametrize("arch", ARCHS)
def test_embed_inputs_match_reference(arch, approx, degree):
    """``embed_inputs`` alone in f32 at the head site's degree: x and the
    positions."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg)
    jd, td = P.degrees(degree)
    with P.jax_backend("pallas"):
        jx, jpos = JT.embed_inputs(jp, jm.cfg, jb, jnp.float32, jm.policy, jd)
    tx, tpos = TM.embed_inputs(tp, tm.cfg, tb, torch.float32, tm.policy, td)
    S = 16 + (jm.cfg.frontend_tokens if arch == VLM else 0)
    assert tuple(tx.shape) == tuple(jx.shape) == (2, S, jm.cfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))


@pytest.mark.parametrize("approx,degree", DEGREES, ids=["exact", "axq8-8", "axq8-6",
                                                        "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(arch, approx, degree):
    """f32 logits within 1e-4, over the VLM's image and text positions."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg)
    jd, td = _degrees(degree, jm.cfg)
    with P.jax_backend("pallas"):
        jl, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, _ = tm.forward(tp, tb, degree=td)
    assert tuple(tl.shape) == tuple(jl.shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=ATOL)


@pytest.mark.parametrize("approx,degree", DEGREES, ids=["exact", "axq8-8", "axq8-6",
                                                        "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(arch, approx, degree):
    """The masked cross-entropy (the VLM's over its text positions only)
    and its token count."""
    jm, jp, tm, tp = P.models("float32", approx, arch=arch)
    jb, tb = _batch(jm.cfg, seed=1)
    jd, td = _degrees(degree, jm.cfg)
    with P.jax_backend("pallas"):
        jl, jmet = jax.jit(lambda p, b, d: jm.loss(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, tmet = tm.loss(tp, tb, degree=td)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    assert float(tmet["ntokens"]) == float(jmet["ntokens"]) == float((tb["labels"] >= 0).sum())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_bf16_bounds(arch):
    """bf16 forward logits under axq8 at degree 8 within the bf16 gate of
    tests/test_torch_models_bf16.py (the frameworks' f32 ulps flip bf16
    roundings; the VLM's gelu is rounded op by op as the reference's)."""
    jm, jp, tm, tp = P.models("bfloat16", "axq8", arch=arch)
    jb, tb = _batch(jm.cfg, seed=2)
    jd, td = P.degrees(8)
    with P.jax_backend("pallas"):
        jl, _ = jax.jit(lambda p, b, d: jm.forward(p, b, degree=d))(jp, jb, jd)
    with torch.no_grad():
        tl, _ = tm.forward(tp, tb, degree=td)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL_BF16)


def test_head_degree_drives_the_frontends():
    """The frontend projections run at the per-site vector's head entry:
    moving it moves ``embed_inputs``; moving a layer entry does not."""
    for arch in ARCHS:
        _, _, tm, tp = P.models("float32", "axq8", arch=arch)
        _, tb = _batch(tm.cfg)
        n = tm.cfg.n_layers + 1
        x = lambda degs: TM.embed_inputs(tp, tm.cfg, tb, torch.float32, tm.policy,
                                         torch.tensor(degs, dtype=torch.int32)[-1])[0]
        base = x([8] * n)
        assert torch.equal(base, x([5] * (n - 1) + [8]))
        assert not torch.equal(base, x([8] * (n - 1) + [5]))
        plan = uniform_plan(tm.cfg)
        plan.validate_for(tm.cfg)
        assert site_names(tm.cfg)[-1] == "head" and len(plan.sites) == n


# ---------------------------------------------------------------------------
# packs, specs, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_packs_bit_for_bit(arch):
    """The reference's ``prepack_params`` of its float tree equals the
    port's of the converted tree, leaf for leaf, the frontend packs and
    their float biases included."""
    from repro.kernels.qstore import prepack_params as jprepack

    jm, jp, _, _ = P.models("float32", "exact", arch=arch)
    cfg = tget_config(arch)
    tm = build_model(cfg, P.tpolicy("axq8", dynamic=True), device="cpu")
    jpk = jprepack(jp, jget_config(arch), P.jpolicy("axq8", dynamic=True))
    tpk = prepack_params(params_from_numpy(jax.tree.map(np.asarray, jp)), cfg, tm.policy)
    fe = "v_proj" if arch == VLM else "a_proj"
    fcs = ("fc1", "fc2") if arch == VLM else ("fc1",)
    for k in fcs:
        assert isinstance(tpk[fe][k]["w"], PackedQWeight)
        assert not isinstance(tpk[fe][k]["b"], PackedQWeight)
    jl = [np.asarray(x) for x in jax.tree_util.tree_leaves(jpk)]
    tl = [x.numpy() for x in tree_leaves(tpk)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_convert_with_frontend_leaves(arch):
    """The converted tree carries the frontend leaves, biases included, and
    the port's own init builds the same shapes."""
    _, jp, _, tp = P.models("float32", "exact", arch=arch)
    fe = "v_proj" if arch == VLM else "a_proj"
    assert set(tp[fe]) == set(jp[fe])
    for k, leaf in tp[fe].items():
        np.testing.assert_array_equal(leaf["w"].numpy(), np.asarray(jp[fe][k]["w"]))
        np.testing.assert_array_equal(leaf["b"].numpy(), np.asarray(jp[fe][k]["b"]))
    own = TM.init_lm(torch.Generator().manual_seed(0), tget_config(arch))
    shapes = lambda t: [tuple(x.shape) for x in tree_leaves(t)]
    assert shapes(own) == [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(jp)]


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["internvl2-1b", "hubert-xlarge"])
def test_input_specs_match_reference(arch, shape):
    js = jregistry.input_specs(jget_config(arch), shape)
    ts = tregistry.input_specs(tget_config(arch), shape)
    assert set(js) == set(ts)
    for k in js:
        assert tuple(ts[k].shape) == tuple(js[k].shape)
    b = tregistry.concrete_batch(tget_config(arch + "-smoke"), 24, 2)
    assert set(b) == set(ts)


def test_encoder_only_refusals_match_reference():
    """hubert has no decode step: ``init_cache`` raises the reference's
    error, and so does ``launch.serve``; the VLM's cache is the dense one
    (text-only decode), with no chunked prefill."""
    from repro_torch.launch import serve as launch_serve

    jm = jregistry.build_model(jget_config(AUDIO))
    with pytest.raises(ValueError, match="encoder-only arch has no decode step") as je:
        jm.init_cache(1, 2, 16)
    tm = build_model(tget_config(AUDIO), device="cpu")
    with pytest.raises(ValueError, match="encoder-only arch has no decode step") as te:
        tm.init_cache(1, 2, 16)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="encoder-only arch has no decode step"):
        launch_serve.run(["--arch", AUDIO, "--device", "cpu"])
    vm = build_model(tget_config(VLM), device="cpu")
    assert not vm.supports_chunked_prefill()
    assert isinstance(vm.init_cache(1, 2, 16, quant=True), LMCacheQ)


# ---------------------------------------------------------------------------
# serving (the VLM, text-only) and training
# ---------------------------------------------------------------------------


def test_vlm_prefill_decode_match_reference():
    """``lm_prefill`` then ``lm_decode_step`` of the VLM's backbone on
    text-only prompts (as the reference serves it), f32 on an f32 cache:
    logits and cache rows within 1e-4."""
    prefill, decode = P.run_prefill_decode("float32", "axq8", 6, "pallas",
                                           cache_dtype=jnp.float32, arch=VLM)
    for stage in (prefill, decode):
        for name, (ref, port) in stage.items():
            np.testing.assert_allclose(port, ref, rtol=0, atol=ATOL, err_msg=name)


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-cache", "int8-cache"])
def test_vlm_engine_streams_match_reference(quant, monkeypatch):
    """internvl2-1b-smoke in f32 under axq8 with the QoS ladder 8 -> 6:
    five text prompts on two slots, exact-length admission on the bf16
    cache and bucketed, packed admission on the int8 cache; the port's
    greedy streams equal the JAX engine's on its Pallas route, and the
    degree walks the same rungs."""
    monkeypatch.setenv("REPRO_KV_INT8", "1" if quant else "0")
    jm, jp, tm, tp = P.models("float32", "axq8", arch=VLM)
    rng = np.random.default_rng(26)
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
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    near_ties = P.compare_streams(jreqs, treqs, margins, 6, LOGIT_TOL)
    assert [d for _, d in teng.stats.degree_history] == \
        [d for _, d in jeng.stats.degree_history]
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


#: a gradient entry below this (1000 x AdamW's eps) is ill-conditioned for
#: a parity check of the update: Adam's first step moves it by lr * g /
#: (|g| + eps), so an f32 rounding of g moves the update by up to ~lr
ILL_GRAD = 1e-5


def _assert_states_close(ts, tmet, js, jmet, ill, start, *, param_atol):
    """tests/_torch_train.py's ``assert_states_close``, except for the
    entries ``ill`` marks (the reference's first gradient below ILL_GRAD:
    the VLM's QKV biases hold some): each of those is held within Adam's
    step bound, 2 lr a step, of its value in ``start`` on both sides."""
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=TT.RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=TT.RTOL)
    assert int(ts.step) == int(js.step) and int(ts.opt.step) == int(js.opt.step)
    bound = 2 * TT.step_cfgs()[1].optimizer.lr * int(ts.step)
    for m, p0, a, b in zip(ill, start, TT.leaves(ts.params), TT.leaves(js.params)):
        np.testing.assert_allclose(a[~m], b[~m], rtol=TT.RTOL, atol=param_atol)
        assert np.abs(a[m] - p0[m]).max(initial=0) <= bound
        assert np.abs(b[m] - p0[m]).max(initial=0) <= bound
    for field in ("mu", "nu"):
        for a, b in zip(TT.leaves(getattr(ts.opt, field)), TT.leaves(getattr(js.opt, field))):
            assert TT.rel_to_max(a, b) <= TT.RTOL, (field, TT.rel_to_max(a, b))


@pytest.mark.parametrize("approx,degree", [("exact", None), ("axq8", 6),
                                           ("axq8", "vector")],
                         ids=["exact", "axq8-6", "axq8-vector"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, approx, degree):
    """One and three ``train_step``s against the reference's jitted step:
    loss, grad norm, every parameter (hubert's unused ``embed`` included:
    a zero gradient, still decayed by AdamW), mu and nu."""
    jm, tm = TT.models(arch, approx)
    js, ts = TT.states(jm)
    jb, tb = _batch(jm.cfg)
    jdeg, tdeg = TT.degrees(degree, jm.cfg.n_layers + 1)
    jcfg, tcfg = TT.step_cfgs(remat="none")
    # the gradients of the start state, every leaf within 1e-5 of its
    # largest entry
    from repro_torch.train import step as tstep

    (_, _), tg = tstep.value_and_grad(tm, ts.params, tb, degree=tdeg, remat="none")
    with P.jax_backend("pallas"):
        jg = jax.jit(jax.grad(lambda p, d: jm.loss(p, jb, degree=d, remat="none")[0]))(
            js.params, jdeg)
    jgl = TT.leaves(jg)
    for a, b in zip(TT.leaves(tg), jgl):
        assert TT.rel_to_max(a, b) <= TT.RTOL
    ill = [np.abs(g) < ILL_GRAD for g in jgl]
    start = TT.leaves(js.params)
    jout = TT.jax_steps(jm, jcfg, js, jb, jdeg, 3)
    tout = TT.port_steps(tm, tcfg, ts, tb, tdeg, 3)
    _assert_states_close(*tout[0], *jout[0], ill, start, param_atol=TT.RTOL)
    _assert_states_close(*tout[2], *jout[2], ill, start, param_atol=TT.PARAM_ATOL_3)
    for (_, tmet), (_, jmet) in zip(tout, jout):
        assert float(tmet["ntokens"]) == float(jmet["ntokens"])
    if arch == VLM:
        assert sum(int(m.sum()) for m in ill) > 0    # the biases' near-zero entries
    if arch == AUDIO:
        e0 = ts.params["embed"]["emb"]
        e3 = tout[2][0].params["embed"]["emb"]
        assert float(tout[0][0].opt.mu["embed"]["emb"].abs().max()) == 0.0
        assert not torch.equal(e0, e3) and float((e3.abs() - e0.abs()).max()) <= 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_policies_give_equal_steps(arch):
    """remat none / dots / full on the frontend archs: the same loss and
    update bit for bit."""
    from repro_torch.train import step as tstep

    jm, tm = TT.models(arch, "axq8")
    _, ts = TT.states(jm)
    _, tb = _batch(jm.cfg)
    outs = []
    for remat in ("none", "dots", "full"):
        _, cfg = TT.step_cfgs(remat=remat)
        st, met = tstep.train_step(tm, cfg, ts, tb, degree=torch.tensor(6, dtype=torch.int32))
        outs.append((float(met["loss"]), [x.clone() for x in tree_leaves(st.params)]))
    for loss, leaves in outs[1:]:
        assert loss == outs[0][0]
        assert all(torch.equal(a, b) for a, b in zip(leaves, outs[0][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_cpu(arch, capsys):
    """``launch.train --device cpu`` on the pipeline's frontend batches
    (the VLM's image and text tokens, the audio encoder's masked frames)
    under axq8 with --qos: every step runs, finite losses."""
    from repro_torch.launch import train as tlaunch

    seq = 24 if arch == VLM else 16
    out = tlaunch.main(["--arch", arch, "--steps", "6", "--seq", str(seq), "--batch", "2",
                        "--approx", "axq8", "--qos", "--device", "cpu"])
    assert out["final_step"] == 6 and not out["preempted"]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert "done at step 6" in capsys.readouterr().out


def test_pipeline_frontend_batches_train_on_both_archs():
    """The synthetic pipeline's batches (bit for bit the reference's) drive
    the port's loss: the VLM's labels cover its text only, hubert's are
    mostly ignored (masked-prediction spans)."""
    from repro.data.pipeline import make_pipeline as jpipe
    from repro_torch.data.pipeline import make_pipeline as tpipe

    for arch, seq in ((VLM, 24), (AUDIO, 32)):
        cfg = tget_config(arch)
        jb = jpipe(jget_config(arch), seq_len=seq, global_batch=2).batch_at(3)
        tb = tpipe(cfg, seq_len=seq, global_batch=2).batch_at(3)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
        m = build_model(cfg, device="cpu")
        params = m.init(seed=0)
        batch = {k: torch.from_numpy(v).long() if v.dtype.kind == "i" else torch.from_numpy(v)
                 for k, v in tb.items()}
        with torch.no_grad():
            loss, met = m.loss(params, batch)
        assert np.isfinite(float(loss))
        assert float(met["ntokens"]) == float((batch["labels"] >= 0).sum())
        if arch == VLM:
            assert batch["labels"].shape[1] == seq - cfg.frontend_tokens
