"""Shared setup and helpers of the ``test_torch_ssm*.py`` files (moved out
of ``tests/test_torch_ssm.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity of the Mamba-2 (SSD) family, ``repro_torch.models.ssm``, on
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
the reference in tests/test_torch_conv_tail.py.
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
# the block, both forms
# ---------------------------------------------------------------------------


def _block(approx="exact", seed=0):
    jm, jp, tm, tp = P.models("float32", approx, arch=ARCH)
    jb = jax.tree.map(lambda a: a[0], jp["layers"])
    tb = TT.layer_params(tp["layers"], 0)
    return jm.cfg, tm.cfg, jm.policy, tm.policy, jb, tb


def _check_bf16(stages):
    for stage in stages:
        ref, port = stage["logits"]
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_ATOL_BF16)
        for name in ("h", "conv"):
            assert _rel(*stage[name][::-1]) <= STATE_REL_BF16, name


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
    'jprepack_params',
    'jcache_ops',
    'JL',
    'jssm',
    'JAdmissionConfig',
    'JServeEngine',
    'tget_config',
    'cache_from_numpy',
    'params_from_numpy',
    'ApproxMode',
    'ApproxPolicy',
    'ApproxSpec',
    'TQoS',
    'PackedQWeight',
    'prepack_params',
    'tcache_ops',
    'TL',
    'tssm',
    'TT',
    'build_model',
    'AdmissionConfig',
    'ServeEngine',
    'ARCH',
    'ATOL',
    'LOGIT_ATOL_BF16',
    'STATE_REL_BF16',
    'LOGIT_TOL',
    '_t',
    '_np',
    '_rel',
    '_block',
    '_check_bf16',
    '_ladder',
    'f32_caches',
]
