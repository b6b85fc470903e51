"""Shared setup and helpers of the ``test_torch_moe*.py`` files (moved out
of ``tests/test_torch_moe.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity of the MoE family (``repro_torch.models.moe`` and its wiring
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
tests/test_torch_kernels.py, at the scale of these outputs).
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


# ---------------------------------------------------------------------------
# the expert-batched GEMMs' plain versions
# ---------------------------------------------------------------------------


def _expert_weights(E, K, N, block, seed):
    rng = np.random.default_rng(seed)
    ws = [rng.standard_normal((E, K, N)).astype(np.float32) / np.sqrt(K) for _ in range(2)]
    jps = [jprepack(jnp.asarray(w), block) for w in ws]
    return jps, [params_from_numpy(jax.tree.map(np.asarray, {"w": p}))["w"] for p in jps]


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


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


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
    'JMode',
    'JPolicy',
    'JSpec',
    'JQoS',
    'jdispatch',
    'jprepack_params',
    'jprepack',
    'jmoe',
    'JServeEngine',
    'tget_config',
    'params_from_numpy',
    'ApproxMode',
    'ApproxPolicy',
    'ApproxSpec',
    'TQoS',
    '_build',
    'taxq',
    'tdispatch',
    'PackedQWeight',
    'prepack_params',
    'build_model',
    'tmoe',
    'TT',
    'LMCacheQ',
    'AdmissionConfig',
    'LMAdapter',
    'ServeEngine',
    'ATOL_MOE',
    'ATOL_LOGITS',
    'LOGIT_ATOL_BF16',
    'CACHE_REL_BF16',
    'GEMM_ATOL',
    'LOGIT_TOL',
    'SMS',
    'GRANITE',
    'QWEN',
    'ARCHS',
    '_cfgs',
    '_policies',
    '_moe_params',
    '_Recorder',
    '_port_routing',
    'MOE_CASES',
    '_expert_weights',
    'fake_card',
    '_meta',
    '_meta_pack',
    '_ladder',
]
