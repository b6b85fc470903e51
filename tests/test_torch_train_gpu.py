"""Training on a Hopper card (``gpu`` marker; they skip elsewhere): the
kernel route under autograd against the plain route on the same card, the
CPU-side twins of chip_smoke.py phase 5b.  This file imports no JAX; the
plain route is held to the reference in tests/test_torch_train_*.py.

Tolerances: the attention gradients bit for bit (the backward oracle reads
only the saved inputs); the blockwise AXQ backward on the card's int8 GEMM
within 1e-6 of each gradient's largest entry against the CPU's float64
products (exact integers either way; the f32 reductions run in another
order); a 2-layer step's loss within 0.25 (the bf16 logit bound of
tests/test_torch_models_bf16.py), the attention projections' gradients
nonzero, and each gradient leaf within 5e-2 relative Frobenius under EXACT;
under AXQ within 4x the model's noise floor + 1e-3 (the plain run's change
when its projections' outputs move by 1e-6 relative and its attention
outputs by one bf16 ulp at random entries: the gradient reaches
x and w only at each block's amax, and a one-ulp bf16 difference can move
an amax, chip_smoke.py's TRAIN_* tolerances)."""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import policy_from_flag
from repro_torch.kernels import _build, axq_grad
from repro_torch.kernels import axqmm as taxq
from repro_torch.kernels import dispatch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels.axqmm import ACTS
from repro_torch.models import build_model, concrete_batch
from repro_torch.tree import tree_leaves
from repro_torch.train import step as tstep


@pytest.fixture
def hopper():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda", 0)


@pytest.fixture
def backend():
    yield dispatch.set_backend
    dispatch.set_backend(None)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_flash_vjp_kernel_route_grads(hopper, backend, dtype):
    g = torch.Generator(device=hopper).manual_seed(1)
    B, S, H, KVr, D = 2, 300, 8, 2, 64
    q = torch.randn(B, S, H, D, generator=g, device=hopper).to(dtype)
    k, v = (torch.randn(B, S, KVr, D, generator=g, device=hopper).to(dtype) for _ in range(2))
    go = torch.randn(B, S, H, D, generator=g, device=hopper).to(dtype)
    grads = {}
    for name in ("cuda", "torch"):
        backend(name)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = dict(_build.launches)
        o = dispatch.prefill_attention(*leaves, causal=True)
        (o.float() * go.float()).sum().backward()
        assert _build.launches["flash_attention"] - before["flash_attention"] == (
            name == "cuda")
        grads[name] = [t.grad for t in leaves]
    for a, b in zip(grads["cuda"], grads["torch"]):
        assert torch.equal(a, b) and bool(a.abs().sum() > 0)


@pytest.mark.gpu
def test_gpu_blockwise_axq_backward_matches_cpu(hopper):
    g = torch.Generator().manual_seed(2)
    M, K, N, blk = 64, 512, 96, 256
    x = torch.randn(M, K, generator=g)
    wu, wg = (torch.randn(K, N, generator=g) / math.sqrt(K) for _ in range(2))
    gy = torch.randn(M, N, generator=g)
    for fn, args in ((axq_grad.qmm_grads, (x, wu, gy, blk, 6)),
                     (axq_grad.qmm_gated_grads, (x, wu, wg, gy, ACTS["silu"], blk, 6))):
        cpu = fn(*args)
        card = fn(*(a.to(hopper) if isinstance(a, torch.Tensor) else a for a in args))
        for a, b in zip(card, cpu):
            err = float((a.cpu() - b).abs().max())
            assert err <= 1e-6 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("approx", ["axq8", "exact"])
def test_gpu_train_step_kernel_route_matches_plain(hopper, backend, approx, monkeypatch):
    """One step of a 2-layer, 512-wide tinyllama (bf16, batch 2 x 256) with
    the kernels against the plain versions on the card."""
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"), n_layers=2, d_model=512,
                              n_heads=8, n_kv_heads=2, d_ff=1408, vocab=4096)
    model = build_model(cfg, policy_from_flag(approx, dynamic=True), device=hopper)
    batch = concrete_batch(cfg, seq=256, batch=2,
                           generator=torch.Generator(device=hopper).manual_seed(3),
                           device=hopper)
    deg = torch.tensor(7, dtype=torch.int32, device=hopper)
    noise = torch.Generator(device=hopper).manual_seed(7)
    plain_mm = taxq.axqmm_packed_plain

    plain_fa = tfa.flash_attention_grouped_plain

    def perturbed(*a, **kw):
        y = plain_mm(*a, **kw)
        return y * (1 + 1e-6 * torch.randn(y.shape, generator=noise, device=hopper))

    def moved(*a, **kw):
        # one bf16 ulp up or down at a random two thirds of the entries
        o = plain_fa(*a, **kw)
        step = torch.randint(-1, 2, o.shape, generator=noise, device=hopper)
        bits = (o.view(torch.int16) + step.to(torch.int16)).view(o.dtype)
        return torch.where(o != 0, bits, o)

    out = {}
    for name, bk in (("cuda", "cuda"), ("torch", "torch"), ("noise", "torch")):
        backend(bk)
        if name == "noise":
            monkeypatch.setattr(taxq, "axqmm_packed_plain", perturbed)
            monkeypatch.setattr(tfa, "flash_attention_grouped_plain", moved)
        state = tstep.init_state(model, seed=0)
        _build.reset_counts()
        (loss, _), grads = tstep.value_and_grad(model, state.params, batch, degree=deg,
                                                remat="none")
        out[name] = (loss, grads, dict(_build.launches), dict(_build.plain_cuda_calls))
    (lk, gk, lau, plain_k), (lp, gp, _, plain_p) = out["cuda"], out["torch"]
    assert lau["flash_attention"] == cfg.n_layers and not any(plain_k.values())
    assert plain_p["flash_attention"] == cfg.n_layers
    assert abs(float(lk) - float(lp)) <= 0.25
    rel = lambda a, b: float(torch.linalg.norm(a - b) / torch.linalg.norm(b).clamp_min(1e-30))
    for a, b, n in zip(tree_leaves(gk), tree_leaves(gp), tree_leaves(out["noise"][1])):
        tol = 5e-2 if approx == "exact" else 4 * rel(n, b) + 1e-3
        assert rel(a, b) <= tol
    for key in ("wq", "wk", "wv"):
        assert float(gk["layers"][key]["w"].abs().sum()) > 0
