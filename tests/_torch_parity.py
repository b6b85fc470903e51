"""Shared set-up of the port's model-level parity tests: one smoke model
built in the JAX reference from a seed, converted through numpy into the
port, and run through the reference's Pallas route (interpret mode on the
CPU) — the route whose kernels the port's plain versions mirror."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget_config
from repro.core.approx import policy_from_flag as jpolicy
from repro.kernels import dispatch as jdispatch
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core.approx import policy_from_flag as tpolicy
from repro_torch.models import build_model as tbuild_model

ARCH = "tinyllama-1.1b-smoke"


@contextlib.contextmanager
def jax_backend(name):
    prev = jdispatch._override
    jdispatch.set_backend(name)
    try:
        yield
    finally:
        jdispatch.set_backend(prev)


_MODELS: dict = {}


def models(dtype: str, approx: str, seed: int = 0, arch: str = ARCH,
           bias_seed=None, **overrides):
    """(jax model, jax params, port model, port params) for the smoke arch
    ``arch`` at ``dtype`` under ``approx`` (dynamic degree), prepacked for
    AXQ, with config fields ``overrides`` replaced on both sides; built
    once per process (the port's params are copies, so a test's in-place
    cache updates never reach them).  ``bias_seed`` fills the QKV bias
    leaves (zeros at init) with seeded N(0, 0.5^2) values first."""
    key = (dtype, approx, seed, arch, bias_seed, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        _MODELS[key] = _build_models(dtype, approx, seed, arch, bias_seed, overrides)
    return _MODELS[key]


def with_qkv_biases(jp, seed: int):
    """The reference's params with every QKV bias leaf replaced by seeded
    N(0, 0.5^2) values (numpy, so both packages get the same numbers)."""
    rng = np.random.default_rng(seed)
    layers = dict(jp["layers"])
    for key in ("wq", "wk", "wv"):
        if "b" in layers[key]:
            b = layers[key]["b"]
            layers[key] = {**layers[key],
                           "b": jnp.asarray(0.5 * rng.standard_normal(b.shape), b.dtype)}
    return {**jp, "layers": layers}


def _build_models(dtype: str, approx: str, seed: int, arch: str, bias_seed, overrides):
    jcfg = dataclasses.replace(jget_config(arch), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tget_config(arch), dtype=dtype, **overrides)
    jm = jbuild_model(jcfg, jpolicy(approx, dynamic=True))
    tm = tbuild_model(tcfg, tpolicy(approx, dynamic=True), device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed), tp=1)
    if bias_seed is not None:
        jp = with_qkv_biases(jp, bias_seed)
    if approx != "exact":
        jp = jm.prepack(jp)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp))


def degrees(kind):
    """The same runtime degree for both packages: None, a scalar, or a
    per-site vector (2 layers + head): "vector" is (8, 6, 5), a tuple gives
    its own entries."""
    if kind is None:
        return None, None
    if kind == "vector" or isinstance(kind, tuple):
        vals = [8, 6, 5] if kind == "vector" else list(kind)
        return jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    return jnp.int32(kind), torch.tensor(kind, dtype=torch.int32)


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()   # caches change in place
    return np.asarray(t, np.float32)


def port_cache(jcache):
    return cache_from_numpy(jax.tree.map(np.asarray, jcache))


_JITS: dict = {}


def run_prefill_decode(dtype, approx, degree_kind, backend, quant=False,
                       cache_dtype=jnp.bfloat16, **model_kw):
    """Prefill a 9-token prompt into slot 1 of a 3-slot cache (``cache_dtype``,
    bf16 by default, or the int8 cache with ``quant``), then one decode step
    with slot 0 free, in both packages; ``model_kw`` goes to :func:`models`
    (arch, bias_seed, config overrides)."""
    jm, jp, tm, tp = models(dtype, approx, **model_kw)
    jdeg, tdeg = degrees(degree_kind)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, 9).astype(np.int32)
    toks = rng.integers(0, 512, (3, 1)).astype(np.int32)
    active = np.array([False, True, True])
    fields = ("k", "v", "ks", "vs") if quant else ("k", "v")
    with jax_backend(backend):
        # jitted per (model, route): the scalar degrees share one compile
        key = (id(jm), backend)
        if key not in _JITS:
            _JITS[key] = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
        prefill_j, decode_j = _JITS[key]
        jc = jm.init_cache(tp=1, batch=3, max_len=32, dtype=cache_dtype, quant=quant)
        tc = port_cache(jc)
        lj, jc = prefill_j(jp, jc, jnp.asarray(prompt), jnp.int32(1), degree=jdeg)
        lt, tc = tm.prefill(tp, tc, torch.from_numpy(prompt), 1, degree=tdeg)
        prefill = dict(logits=(to_np(lj), to_np(lt)))
        prefill.update({f: (to_np(getattr(jc, f)), to_np(getattr(tc, f)))
                        for f in fields})
        lj2, jc2 = decode_j(jp, jc, jnp.asarray(toks), degree=jdeg,
                            active=jnp.asarray(active))
        lt2, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                  degree=tdeg, active=torch.from_numpy(active))
    live = np.flatnonzero(active)
    decode = dict(logits=(to_np(lj2)[live], to_np(lt2)[live]))
    decode.update({f: (to_np(getattr(jc2, f))[:, live], to_np(getattr(tc2, f))[:, live])
                   for f in fields})
    assert to_np(tc2.length).tolist() == to_np(jc2.length).tolist()
    return prefill, decode


_STATE_REFS: dict = {}


def _state_reference(jm, jp, jdeg, prompt, toks, active, cdt, max_len, compiled):
    """The reference side of :func:`run_state_prefill_decode`: one dict a
    stage (prefill, each step) of numpy arrays, the logits and every cache
    field, and the final lengths."""
    jit = jax.jit if compiled else (lambda f: f)
    out = []
    with jax_backend("pallas"), jax.disable_jit(not compiled):
        jc = jm.init_cache(tp=1, batch=3, max_len=max_len, dtype=cdt)
        lj, jc = jit(jm.prefill)(jp, jc, jnp.asarray(prompt), jnp.int32(1), degree=jdeg)
        out.append({"logits": to_np(lj), **{f: to_np(getattr(jc, f)) for f in jc._fields}})
        step = jit(jm.decode_step)
        for t in toks:
            lj, jc = step(jp, jc, jnp.asarray(t), degree=jdeg, active=jnp.asarray(active))
            out.append({"logits": to_np(lj), **{f: to_np(getattr(jc, f)) for f in jc._fields}})
    return out


def run_state_prefill_decode(dtype, approx, degree, *, prompt_len, steps=1, max_len=48,
                             compiled=True, **model_kw):
    """The recurrent families' form of :func:`run_prefill_decode`: prefill
    a ``prompt_len``-token prompt into slot 1 of a 3-slot cache (f32 for an
    f32 model, else bf16), then ``steps`` decode steps with slot 0 free, in
    both packages.  Returns one dict a stage (prefill, each step) of
    (reference, port) arrays for the logits and every cache field of the
    live slots.  ``compiled=False`` evaluates the reference op by op
    (``jax.disable_jit``).  The reference side is computed once a process
    for each set of arguments (a test that runs the port twice against one
    reference, with and without a patch of the port, reads it twice)."""
    jm, jp, tm, tp = models(dtype, approx, **model_kw)
    jdeg, tdeg = degrees(degree)
    rng = np.random.default_rng(prompt_len + steps)
    prompt = rng.integers(0, 512, prompt_len).astype(np.int32)
    toks = [rng.integers(0, 512, (3, 1)).astype(np.int32) for _ in range(steps)]
    active = np.array([False, True, True])
    cdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    key = (dtype, approx, degree, prompt_len, steps, max_len, compiled,
           tuple(sorted(model_kw.items())))
    if key not in _STATE_REFS:
        _STATE_REFS[key] = _state_reference(jm, jp, jdeg, prompt, toks, active, cdt,
                                            max_len, compiled)
    ref = _STATE_REFS[key]
    tc = port_cache(jm.init_cache(tp=1, batch=3, max_len=max_len, dtype=cdt))
    fields = [f for f in tc._fields if f != "length"]
    lt, tc = tm.prefill(tp, tc, torch.from_numpy(prompt), 1, degree=tdeg)
    out = [{"logits": (ref[0]["logits"], to_np(lt)),
            **{f: (ref[0][f][:, 1], to_np(getattr(tc, f))[:, 1]) for f in fields}}]
    for r, t in zip(ref[1:], toks):
        lt, tc = tm.decode_step(tp, tc, torch.from_numpy(t).long(), degree=tdeg,
                                active=torch.from_numpy(active))
        out.append({"logits": (r["logits"][1:], to_np(lt)[1:]),
                    **{f: (r[f][:, 1:], to_np(getattr(tc, f))[:, 1:]) for f in fields}})
    assert to_np(tc.length).tolist() == ref[-1]["length"].tolist()
    return out


def padded_rows(lens, Pb, seed):
    """Seeded prompts of ``lens`` tokens and the (N, Pb) int32 rows they
    make padded with zeros to one bucket."""
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, 512, n).astype(np.int32) for n in lens]
    toks = np.zeros((len(lens), Pb), np.int32)
    for i, r in enumerate(rows):
        toks[i, :len(r)] = r
    return rows, toks


class MarginRecorder:
    """Wraps a port model: keeps the top-2 logit margin of the last decode
    step per slot, so a harvested token can be paired with its margin."""

    def __init__(self, model):
        self._model = model
        self.last = None

    def __getattr__(self, name):
        return getattr(self._model, name)

    def decode_step(self, *a, **kw):
        logits, cache = self._model.decode_step(*a, **kw)
        top2 = torch.topk(logits[:, 0, :self._model.cfg.vocab].float(), 2).values
        self.last = (top2[:, 0] - top2[:, 1]).tolist()
        return logits, cache


def record_margins(engine) -> dict:
    """Wrap a port engine's model and harvest so that every harvested token
    is paired with its step's top-2 margin: {(rid, token index): margin}."""
    rec = MarginRecorder(engine.workload.model)
    engine.workload.model = rec
    margins: dict = {}
    harvest = engine.workload.harvest

    def harvest_and_note(req, feed, slot, emission):
        margins[(req.rid, len(req.out))] = rec.last[slot]
        return harvest(req, feed, slot, emission)

    engine.workload.harvest = harvest_and_note
    return margins


def compare_streams(jreqs, treqs, margins, new_tokens, tol):
    """Token streams of the two engines' requests: equal, except that a
    token where the port's top-2 margin is below ``tol`` is a near-tie (the
    two packages round differently), which ends the comparison of that
    request.  Returns the near-ties as (rid, token index)."""
    near_ties = []
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.out_tokens) == len(jr.out_tokens) == new_tokens
        for t, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)):
            if a != b:
                assert margins[(tr.rid, t)] < tol, (tr.rid, t, a, b)
                near_ties.append((tr.rid, t))
                break
    return near_ties
