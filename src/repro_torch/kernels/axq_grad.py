"""The backward of the float-weight AXQ cores, block by block.

The reference differentiates its ``qmm_ref`` oracle (``jax.vjp``).  In that
oracle the rounding and the int8 cast carry no gradient, so the gradient
reaches x and w only through the block scales: ``y[m, n] = sum_b A_b[m, n] *
sx[m, b] * sw[n, b]`` with ``A_b`` the exact integer product of block ``b``
of the degraded codes, and each scale ``max(amax, 1e-30) / 127`` of its
block's ``amax``.  So

    dsx[m, b] = sum_n g[m, n] A_b[m, n] sw[n, b]
    dsw[n, b] = sum_m g[m, n] A_b[m, n] sx[m, b]

and each block's d(scale) / 127 goes to the entries at its ``amax``, split
evenly between equal maxima (as ``torch.amax``'s and XLA's reduce-max
gradients split it), times their sign.  Autograd through ``qmm_ref`` builds
the (M, N, nb) products at once (float64 in the port's oracle: 16.8 GB at
tinyllama's training unembedding); here one exact (M, N) block product is
alive at a time: ``torch._int_mm`` on the card (int32, exact), a float64
product on the CPU or where the card's int8 GEMM refuses the shape.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import degrade, quantize_block

Tensor = torch.Tensor


def _block_product(vx: Tensor, vw: Tensor) -> Tensor:
    """Exact integer product of int8 codes vx (M, blk) and vw (N, blk) as an
    (M, N) f32 (every entry is an integer below 127^2 * blk); on meta
    tensors (the dry run) the card's form."""
    if (vx.is_cuda or vx.is_meta) and vw.shape[0] % 8 == 0 and vx.shape[1] % 8 == 0:
        from repro_torch.kernels.ops import int_product

        return int_product(vx.contiguous(), vw.contiguous().t()).to(torch.float32)
    return (vx.to(torch.float64) @ vw.to(torch.float64).t()).to(torch.float32)


def _operands(x: Tensor, w: Tensor, block: int, ebits):
    """(x f32, w^T f32, the degraded codes (M, nb, blk) / (N, nb, blk), their
    scales (M, nb) / (N, nb))."""
    x32 = x.to(torch.float32)
    wt = w.t().to(torch.float32)
    qx, qw = quantize_block(x32, block), quantize_block(wt, block)
    nb = qx.scales.shape[-1]
    vx = degrade(qx.values, ebits).reshape(x.shape[0], nb, block)
    vw = degrade(qw.values, ebits).reshape(wt.shape[0], nb, block)
    return x32, wt, vx, vw, qx.scales, qw.scales


def _scale_chain(v: Tensor, dscale: Tensor) -> Tensor:
    """Gradient of ``v`` (rows, K) through its block scales
    ``max(amax, 1e-30) / 127`` given d(scale) (rows, nb)."""
    rows, K = v.shape
    nb = dscale.shape[-1]
    a = v.reshape(rows, nb, K // nb).abs()
    amax = a.amax(dim=-1, keepdim=True)
    hit = (a == amax).to(torch.float32)
    g = torch.where(amax >= 1e-30, dscale[..., None] / 127.0, 0.0)
    g = g / hit.sum(dim=-1, keepdim=True) * hit
    return (g * torch.sign(v.reshape(rows, nb, K // nb))).reshape(rows, K)


def _scale_grads(g: Tensor, vx, vw, sx, sw) -> tuple[Tensor, Tensor]:
    """(dsx (M, nb), dsw (N, nb)) of one product's cotangent ``g`` (M, N)."""
    nb = sx.shape[-1]
    dsx = torch.empty_like(sx)
    dsw = torch.empty_like(sw)
    for b in range(nb):
        ga = g * _block_product(vx[:, b], vw[:, b])
        dsx[:, b] = (ga * sw[None, :, b]).sum(dim=1)
        dsw[:, b] = (ga * sx[:, None, b]).sum(dim=0)
    return dsx, dsw


def qmm_grads(x: Tensor, w: Tensor, g: Tensor, block: int, ebits) -> tuple[Tensor, Tensor]:
    """(dx (M, K), dw (K, N)) of ``qmm_ref(x, w, block, ebits)`` for the
    cotangent ``g`` (M, N), in f32."""
    x32, wt, vx, vw, sx, sw = _operands(x, w, block, ebits)
    dsx, dsw = _scale_grads(g.to(torch.float32), vx, vw, sx, sw)
    return _scale_chain(x32, dsx), _scale_chain(wt, dsw).t()


def qmm_gated_grads(x: Tensor, w_up: Tensor, w_gate: Tensor, g: Tensor, act,
                    block: int, ebits) -> tuple[Tensor, Tensor, Tensor]:
    """(dx, dw_up, dw_gate) of ``qmm_gated_ref(x, w_up, w_gate, act, block,
    ebits)`` = ``act(gate) * up`` for the cotangent ``g``, in f32.  The two
    products are first rebuilt block by block in the oracle's block order
    (bit for bit), then each one's cotangent goes through its scales."""
    x32, ut, vx, vu, sx, su = _operands(x, w_up, block, ebits)
    _, gt, _, vg, _, sg = _operands(x, w_gate, block, ebits)
    up = gate = None
    for b in range(sx.shape[-1]):
        tu = _block_product(vx[:, b], vu[:, b]) * (sx[:, None, b] * su[None, :, b])
        tg = _block_product(vx[:, b], vg[:, b]) * (sx[:, None, b] * sg[None, :, b])
        up = tu if up is None else up + tu
        gate = tg if gate is None else gate + tg
    g = g.to(torch.float32)
    with torch.enable_grad():
        gate = gate.requires_grad_()
        a = act(gate)
        (g_gate,) = torch.autograd.grad(a, gate, g * up)
    g_up = g * a.detach()
    del up, gate, a
    dsx_u, dsu = _scale_grads(g_up, vx, vu, sx, su)
    dsx_g, dsg = _scale_grads(g_gate, vx, vg, sx, sg)
    dx = _scale_chain(x32, dsx_u) + _scale_chain(x32, dsx_g)
    return dx, _scale_chain(ut, dsu).t(), _scale_chain(gt, dsg).t()
