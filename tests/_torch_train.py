"""Shared set-up of the port's training parity tests: one smoke model's
training state built in the JAX reference from a seed, converted through
numpy into the port's TrainState, the same numpy batch fed to both, and the
reference's step jitted on its Pallas route (interpret mode on the CPU)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import jax_backend
from repro.configs import get_config as jget_config
from repro.core.approx import policy_from_flag as jpolicy
from repro.models import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.approx import policy_from_flag as tpolicy
from repro_torch.models import build_model as tbuild_model
from repro_torch.tree import tree_leaves
from repro_torch.train import step as tstep

#: loss, grad_norm and params after one step, and mu / nu (relative to
#: each leaf's largest entry) after every step
RTOL = 1e-5
#: params after 3 steps (the AdamW update divides by sqrt(nu): a last-ulp
#: difference of a small nu entry moves its parameter by up to ~1e-5)
PARAM_ATOL_3 = 1e-4


def models(arch: str, approx: str, dtype: str = "float32", **overrides):
    """(jax model, port model) of ``arch`` at ``dtype`` under ``approx``
    (dynamic degree) with config fields ``overrides`` on both sides."""
    jcfg = dataclasses.replace(jget_config(arch), dtype=dtype, **overrides)
    tcfg = dataclasses.replace(tget_config(arch), dtype=dtype, **overrides)
    return (jbuild_model(jcfg, jpolicy(approx, dynamic=True)),
            tbuild_model(tcfg, tpolicy(approx, dynamic=True), device="cpu"))


def states(jm, seed: int = 0):
    """(jax TrainState, the port's converted copy)."""
    js = jstep.init_state(jm, jax.random.PRNGKey(seed))
    return js, train_state_from_numpy(jax.tree.map(np.asarray, js))


def batches(cfg, B: int = 2, S: int = 16, seed: int = 0):
    """(jax batch, port batch): next-token pairs of one numpy draw."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    return jb, tb


def degrees(kind, n_sites: int):
    """None, a scalar, or a per-site vector cycling (8, 6, 7, 5)."""
    if kind is None:
        return None, None
    if kind == "vector":
        vals = [(8, 6, 7, 5)[i % 4] for i in range(n_sites)]
        return jnp.asarray(vals, jnp.int32), torch.tensor(vals, dtype=torch.int32)
    return jnp.int32(kind), torch.tensor(kind, dtype=torch.int32)


def jax_steps(jm, scfg, js, jb, jdeg, n: int, backend: str = "pallas"):
    """[(state, metrics)] after each of ``n`` reference steps."""
    out = []
    with jax_backend(backend):
        f = jax.jit(lambda s, b, d: jstep.train_step(jm, scfg, s, b, degree=d))
        for _ in range(n):
            js, met = f(js, jb, jdeg)
            out.append((js, met))
    return out


def port_steps(tm, scfg, ts, tb, tdeg, n: int):
    out = []
    for _ in range(n):
        ts, met = tstep.train_step(tm, scfg, ts, tb, degree=tdeg)
        out.append((ts, met))
    return out


def step_cfgs(**kw):
    """(jax StepConfig, port StepConfig) with the same fields."""
    kw.setdefault("total_steps", 10)
    kw.setdefault("warmup", 2)
    return jstep.StepConfig(**kw), tstep.StepConfig(**kw)


def leaves(tree) -> list:
    """numpy leaves of either package's tree, in JAX's flatten order."""
    if isinstance(tree, torch.Tensor) or any(isinstance(x, torch.Tensor)
                                             for x in tree_leaves(tree)):
        return [x.detach().numpy() for x in tree_leaves(tree)]
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def rel_to_max(port, ref) -> float:
    """max |port - ref| over max |ref| (0 for an all-zero leaf pair)."""
    scale = float(np.abs(ref).max())
    err = float(np.abs(port - ref).max())
    return 0.0 if err == 0 else err / max(scale, 1e-30)


def assert_states_close(ts, tmet, js, jmet, *, param_atol: float):
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=RTOL)
    assert int(ts.step) == int(js.step) and int(ts.opt.step) == int(js.opt.step)
    for a, b in zip(leaves(ts.params), leaves(js.params)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=param_atol)
    for field in ("mu", "nu"):
        for a, b in zip(leaves(getattr(ts.opt, field)), leaves(getattr(js.opt, field))):
            assert rel_to_max(a, b) <= RTOL, (field, rel_to_max(a, b))
