"""Shared setup and helpers of the ``test_torch_head128*.py`` files (moved out
of ``tests/test_torch_head128.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity at head_dim 128, the reference's own TPU head dim: the two
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
test_torch_serve.py).
"""
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


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25,
                high_water=0.75, cooldown_steps=2)


__all__ = [
    'jax',
    'jnp',
    'np',
    'pytest',
    'torch',
    'P',
    'JQoS',
    'jfa',
    'jfd',
    'JAdmissionConfig',
    'JServeEngine',
    'params_from_numpy',
    'TQoS',
    '_build',
    'tfa',
    'tfd',
    'PackedQWeight',
    'LMCacheQ',
    'AdmissionConfig',
    'ServeEngine',
    'RTOL',
    'ATOL',
    'ATOL_QUANT',
    'ATOL_LOGITS',
    'LOGIT_TOL',
    'QWEN',
    'NEMO',
    'D',
    '_t',
    'fake_card',
    '_meta',
    '_ladder',
]
