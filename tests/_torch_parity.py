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


def models(dtype: str, approx: str, seed: int = 0):
    """(jax model, jax params, port model, port params) for the smoke arch
    at ``dtype`` under ``approx`` (dynamic degree), prepacked for AXQ;
    built once per process (the port's params are copies, so a test's
    in-place cache updates never reach them)."""
    key = (dtype, approx, seed)
    if key not in _MODELS:
        _MODELS[key] = _build_models(dtype, approx, seed)
    return _MODELS[key]


def _build_models(dtype: str, approx: str, seed: int):
    jcfg = dataclasses.replace(jget_config(ARCH), dtype=dtype)
    tcfg = dataclasses.replace(tget_config(ARCH), dtype=dtype)
    jm = jbuild_model(jcfg, jpolicy(approx, dynamic=True))
    tm = tbuild_model(tcfg, tpolicy(approx, dynamic=True), device="cpu")
    jp = jm.init(jax.random.PRNGKey(seed), tp=1)
    if approx != "exact":
        jp = jm.prepack(jp)
    return jm, jp, tm, params_from_numpy(jax.tree.map(np.asarray, jp))


def degrees(kind):
    """The same runtime degree for both packages: None, a scalar, or a
    per-site vector (2 layers + head)."""
    if kind is None:
        return None, None
    if kind == "vector":
        vals = [8, 6, 5]
        return jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    return jnp.int32(kind), torch.tensor(kind, dtype=torch.int32)


def to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy().copy()   # caches change in place
    return np.asarray(t, np.float32)


def port_cache(jcache):
    return cache_from_numpy(jax.tree.map(np.asarray, jcache))


_JITS: dict = {}


def run_prefill_decode(dtype, approx, degree_kind, backend):
    """Prefill a 9-token prompt into slot 1 of a 3-slot cache, then one
    decode step with slot 0 free, in both packages."""
    jm, jp, tm, tp = models(dtype, approx)
    jdeg, tdeg = degrees(degree_kind)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, 512, 9).astype(np.int32)
    toks = rng.integers(0, 512, (3, 1)).astype(np.int32)
    active = np.array([False, True, True])
    with jax_backend(backend):
        # jitted per (model, route): the scalar degrees share one compile
        key = (id(jm), backend)
        if key not in _JITS:
            _JITS[key] = (jax.jit(jm.prefill), jax.jit(jm.decode_step))
        prefill_j, decode_j = _JITS[key]
        jc = jm.init_cache(tp=1, batch=3, max_len=32)
        tc = port_cache(jc)
        lj, jc = prefill_j(jp, jc, jnp.asarray(prompt), jnp.int32(1), degree=jdeg)
        lt, tc = tm.prefill(tp, tc, torch.from_numpy(prompt), 1, degree=tdeg)
        prefill = dict(logits=(to_np(lj), to_np(lt)), k=(to_np(jc.k), to_np(tc.k)),
                       v=(to_np(jc.v), to_np(tc.v)))
        lj2, jc2 = decode_j(jp, jc, jnp.asarray(toks), degree=jdeg,
                            active=jnp.asarray(active))
        lt2, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks).long(),
                                  degree=tdeg, active=torch.from_numpy(active))
    live = np.flatnonzero(active)
    decode = dict(logits=(to_np(lj2)[live], to_np(lt2)[live]),
                  k=(to_np(jc2.k)[:, live], to_np(tc2.k)[:, live]),
                  v=(to_np(jc2.v)[:, live], to_np(tc2.v)[:, live]))
    assert to_np(tc2.length).tolist() == to_np(jc2.length).tolist()
    return prefill, decode
