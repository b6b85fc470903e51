"""Shared setup and helpers of the ``test_torch_frontends*.py`` files (moved out
of ``tests/test_torch_frontends.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity of the frontend archs: internvl2-1b-smoke (the VLM: patch
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
within Adam's step bound (ROADMAP §C).
"""
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


def _ladder():
    return dict(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25, high_water=0.75,
                cooldown_steps=2)


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


__all__ = [
    'jax',
    'jnp',
    'np',
    'pytest',
    'torch',
    'P',
    'TT',
    'jget_config',
    'JQoS',
    'jregistry',
    'JT',
    'JAdmissionConfig',
    'JServeEngine',
    'tget_config',
    'params_from_numpy',
    'TQoS',
    'PackedQWeight',
    'prepack_params',
    'build_model',
    'tregistry',
    'TM',
    'LMCacheQ',
    'AdmissionConfig',
    'ServeEngine',
    'tree_leaves',
    'site_names',
    'uniform_plan',
    'VLM',
    'AUDIO',
    'ARCHS',
    'ATOL',
    'LOGIT_ATOL_BF16',
    'LOGIT_TOL',
    'DEGREES',
    '_batch',
    '_degrees',
    '_ladder',
    'ILL_GRAD',
    '_assert_states_close',
]
