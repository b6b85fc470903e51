"""Shared setup and helpers of the ``test_torch_rglru*.py`` files (moved out
of ``tests/test_torch_rglru.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity of the RG-LRU hybrid family, ``repro_torch.models.rglru``, on
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
head128.py).
"""
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


def _block():
    jm, jp, tm, tp = _models("float32", "exact")
    jb = jax.tree.map(lambda a: a[0], jp["groups"]["rec0"])
    tb = TT.layer_params(tp["groups"]["rec0"], 0)
    return jm, tm, jb, tb


def run_prefill_decode(dtype, approx, degree, prompt_len=20, **kw):
    return P.run_state_prefill_decode(dtype, approx, degree, prompt_len=prompt_len,
                                      arch=ARCH, n_layers=LAYERS, **kw)


def _check_bf16(stages):
    for stage in stages:
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("k", "v", "h", "conv"):
            assert _rel(*stage[name][::-1]) <= CACHE_REL_BF16, name


def rounded_activations_hold_bf16_parity(degree, monkeypatch):
    """The recurrent blocks' op-by-op activations (``layers.act_rounded``)
    are what holds bf16 parity at the low degrees: with them the port sits
    within the bounds of the reference evaluated op by op (at degree 6 the
    compiled one is the same program: test_prefill_decode_bf16_match_
    reference), while the GEMM epilogue's fused forms (``ACTS``:
    ``F.silu``, ``F.gelu``) put the logits past the bf16 bound (ROADMAP
    §C: the reference rounds bf16 activations op by op)."""
    rounded = run_prefill_decode("bfloat16", "axq8", degree, steps=2, compiled=False)
    _check_bf16(rounded)
    for name in ("silu", "gelu"):
        monkeypatch.setitem(TL._ROUNDED_ACTS, name, ACTS[name])
    fused = run_prefill_decode("bfloat16", "axq8", degree, steps=2, compiled=False)

    def worst(stages):
        return max(float(np.abs(s["logits"][1] - s["logits"][0]).max()) for s in stages)

    print(f"degree {degree}: rounded {worst(rounded)}, fused {worst(fused)}")
    assert worst(fused) > max(worst(rounded), LOGIT_ATOL_BF16)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


def engine_streams_match_reference(admission, monkeypatch):
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


__all__ = [
    'dataclasses',
    'functools',
    'jax',
    'jnp',
    'np',
    'pytest',
    'torch',
    'P',
    'jget_config',
    'JQoS',
    'jfa',
    'jfd',
    'jprepack_params',
    'jcache_ops',
    'jrg',
    'JAdmissionConfig',
    'JServeEngine',
    'tget_config',
    'cache_from_numpy',
    'params_from_numpy',
    'ApproxMode',
    'ApproxPolicy',
    'ApproxSpec',
    'TQoS',
    '_build',
    'tfa',
    'tfd',
    'ACTS',
    'PackedQWeight',
    'prepack_params',
    'tcache_ops',
    'TL',
    'trg',
    'TT',
    'AdmissionConfig',
    'ServeEngine',
    'ARCH',
    'LAYERS',
    'ATOL',
    'SCAN_ATOL',
    'LOGIT_ATOL_BF16',
    'CACHE_REL_BF16',
    'LOGIT_TOL',
    'RTOL_K',
    'ATOL_K',
    'D',
    '_t',
    '_np',
    '_rel',
    '_models',
    '_block',
    'run_prefill_decode',
    '_check_bf16',
    'rounded_activations_hold_bf16_parity',
    '_ladder',
    'engine_streams_match_reference',
    'fake_card',
    '_meta',
]
