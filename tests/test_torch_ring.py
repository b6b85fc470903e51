"""Port parity of the int8 ring all-reduce (``repro_torch.dist.collectives.
ring_allreduce_int8``) against the reference's ``ring_allreduce_int8_local``,
and the process-group plumbing under it (``repro_torch.dist.meshctx``).

The reference's ring runs under ``shard_map`` on an 8-device host mesh in a
subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
tests/test_collectives.py runs it), compiled, and here op by op: the same
function under ``jax.disable_jit`` and a ``vmap`` over the axis (its
``axis_index``, ``psum`` and ``ppermute`` on the vmapped axis).  The port's
runs on n spawned CPU ranks (gloo, ``FileStore`` rendezvous, one thread a
rank).  For n = 2, 3, 4 and 8, in f32 and bf16, on
flat sizes that need padding to n chunks, every rank's output equals the
reference device's op-by-op output bit for bit, and each rank counts
``2 (n-1) (chunk + 4)`` wire bytes (n-1 reduce-scatter and n-1 all-gather
hops of an int8 chunk and its f32 scale).

The compiled reference is no tighter a bound than its op-by-op run: XLA
contracts a hop's dequantize-and-add into one fused multiply-add, one
rounding instead of two (up to 3.8e-06 apart at n = 8 on these inputs;
ROADMAP §C).  A rounding can move a code of the next hop by one, so the
port is held to the compiled ring within one quantization step of the
largest chunk (amax / 127 a hop, summed over the 2 (n-1) hops)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_tp as H
from repro.dist.collectives import ring_allreduce_int8_local
from repro_torch.dist import meshctx

ROOT = Path(__file__).resolve().parents[1]
NS = (2, 3, 4, 8)
SHAPES = ((3, 37), (1, 1000))

_JAX_RING = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.dist import meshctx
from repro.dist.collectives import ring_allreduce_int8_local

src, dst = sys.argv[1], sys.argv[2]
cases = dict(np.load(src))
out = {}
for key, x in cases.items():
    n, dtype = int(key.split("_")[0]), key.split("_")[1]
    mesh = meshctx.make_mesh((1, n), ("data", "model"))
    rows = x.shape[1]
    xs = jnp.asarray(x.reshape(n * rows, -1), getattr(jnp, dtype))
    f = jax.jit(jax.shard_map(lambda v: ring_allreduce_int8_local(v, "model"), mesh=mesh,
                              in_specs=P("model", None), out_specs=P("model", None),
                              check_vma=False))
    out[key] = np.asarray(f(xs).astype(jnp.float32)).reshape(x.shape)
np.savez(dst, **out)
print("JAX_RING_OK")
"""


def _cases() -> dict:
    """{"n_dtype_rows_cols": (n, rows, cols) per-device inputs}, bf16
    inputs rounded to bf16 first (both sides then hold the same values)."""
    rng = np.random.default_rng(0)
    out = {}
    for n in NS:
        for dtype in ("float32", "bfloat16"):
            for rows, cols in SHAPES:
                x = rng.standard_normal((n, rows, cols)).astype(np.float32)
                x *= rng.uniform(0.1, 10.0, (n, 1, 1)).astype(np.float32)
                if dtype == "bfloat16":
                    x = torch.from_numpy(x).bfloat16().float().numpy()
                out[f"{n}_{dtype}_{rows}_{cols}"] = x
    return out


def _op_by_op(x: np.ndarray, dtype: str) -> np.ndarray:
    """The reference ring of the n slices of ``x`` in ``dtype``, op by op."""
    import jax
    import jax.numpy as jnp

    dt = getattr(jnp, dtype)
    with jax.disable_jit():
        y = jax.vmap(lambda v: ring_allreduce_int8_local(v, "i"), axis_name="i")(
            jnp.asarray(x, dt))
    return np.asarray(y.astype(jnp.float32))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The inputs and the reference's per-device outputs: op by op, and
    compiled under shard_map in one subprocess run (keys ``jit_*``)."""
    d = tmp_path_factory.mktemp("ring")
    cases = _cases()
    np.savez(d / "in.npz", **cases)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _JAX_RING, str(d / "in.npz"), str(d / "out.npz")],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=240)
    assert "JAX_RING_OK" in r.stdout, r.stderr[-3000:]
    out = {"jit_" + k: v for k, v in np.load(d / "out.npz").items()}
    for key, x in cases.items():
        out[key] = _op_by_op(x, key.split("_")[1])
    return cases, out


@pytest.mark.parametrize("n", NS)
def test_ring_matches_reference_bit_for_bit(reference, n, tmp_path):
    cases, want = reference
    mine = {k: (x, k.split("_")[1]) for k, x in cases.items() if k.startswith(f"{n}_")}
    got = meshctx.spawn_ranks(H.ring_rank, n, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(mine,))
    for key, (x, _) in mine.items():
        size = x[0].size
        chunk = -(-size // n)
        exact = x.astype(np.float64).sum(0)
        for r in range(n):
            y, counted = got[r][key]
            assert np.array_equal(y, want[key][r]), (key, r, np.abs(y - want[key][r]).max())
            step = 2 * (n - 1) * np.abs(exact).max() / 127
            assert np.abs(y - want["jit_" + key][r]).max() <= step
            assert counted["bytes"] == {"collective-permute": 2 * (n - 1) * (chunk + 4)}
            assert counted["calls"] == {"collective-permute": 2 * (n - 1)}
            # the reference's envelope: < 5% of the largest sum
            assert np.abs(y - exact).max() < 0.05 * np.abs(exact).max()


def test_exact_collectives_and_group_refusals(tmp_path):
    """all_reduce / all_gather are exact, the broadcast shares rank 0's
    value, and a mesh of more ranks than the group raises."""
    got = meshctx.spawn_ranks(H.collectives_rank, 2, store_dir=str(tmp_path),
                              timeout_s=H.TIMEOUT_S)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    for s, a, t, transport in got:
        assert np.array_equal(s, 3 * x)
        assert np.array_equal(a, np.concatenate([x, 2 * x], axis=-1))
        assert t == 10.0 and transport == "gloo"


def test_ring_is_the_identity_without_a_group():
    x = torch.randn(5, 7)
    from repro_torch.dist import collectives

    assert collectives.ring_allreduce_int8(x, None) is x
    assert collectives.all_reduce(x, None) is x
    assert collectives.all_gather(x, None) is x


def test_spawn_ranks_fails_on_a_raising_or_hanging_rank(tmp_path):
    """A rank that raises fails the call with its traceback; one that
    outlives the bound fails it with the missing ranks; the others are
    killed either way."""
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank one fails on purpose"):
        meshctx.spawn_ranks(H.failing_rank, 2, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S)
    with pytest.raises(RuntimeError, match=r"ranks \[1\] did not finish within 8 s"):
        meshctx.spawn_ranks(H.hanging_rank, 2, store_dir=str(tmp_path), timeout_s=8)
    assert not list(tmp_path.iterdir())          # the store directories are removed


def test_backends_resolve_or_refuse():
    """The CPU runs gloo (nccl refused); ranks that share a card need gloo
    asked for by name (this host has no card, so any rank shares one)."""
    assert meshctx.resolve_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        meshctx.resolve_backend("cpu", 2, "nccl")
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            meshctx.resolve_backend("cuda", 2)
        with pytest.raises(ValueError, match="--dist-backend gloo"):
            meshctx.resolve_backend("cuda", 2, "nccl")
