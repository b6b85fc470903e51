"""Port parity of the *_EMUL / POW2_W arithmetic: the packs
(``qstore.prepack_emul_weight``), ``ops.approx_matmul`` in every mode, a
tinyllama-1.1b-smoke forward under each emulation policy, and the packs
carried across through ``convert`` — all against the JAX reference in the
same process, inputs from numpy seeds.

The *_EMUL products are integer arithmetic end to end (per-tensor int8
codes, operand transforms, an exact int32 product, one f32 rescale), so
the packs and the outputs are held bit for bit, including the int8 wrap of
an encoded 128 to -128.  POW2_W's snapped weights are bit-identical; its
product is an f32 float GEMM, held to 1e-5 (ROADMAP §C).  The f32 forward is held to 1e-4 (ROADMAP §C):
its f32 rmsnorm / rope / softmax differ in the last ulp between XLA and
torch, which can move a per-tensor activation code by one."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.approx import ApproxMode as JMode
from repro.core.approx import ApproxSpec as JSpec
from repro.core.approx import uniform as juniform
from repro.kernels import ops as jops
from repro.kernels import qstore as jqstore
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import encodings as tenc
from repro_torch.core.approx import ApproxMode as TMode
from repro_torch.core.approx import ApproxSpec as TSpec
from repro_torch.core.approx import uniform as tuniform
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qstore as tqstore
from repro_torch.models import build_model as tbuild_model

torch.set_num_threads(2)

ARCH = "tinyllama-1.1b-smoke"

#: (mode, knobs) of every emulation spec the packs are held at
PACK_SPECS = ([("pr_emul", dict(p=p, r=r)) for p in (0, 1, 2) for r in (0, 2, 4)]
              + [("rad_emul", dict(k=k)) for k in (4, 6)]
              + [("roup_emul", dict(k=4, p=p, r=1)) for p in (0, 1)])

#: one spec a mode for the products and the forward (the 3k knobs)
MODE_SPECS = (("pr_emul", dict(p=1, r=2)), ("rad_emul", dict(k=4)),
              ("roup_emul", dict(k=4, p=1, r=1)), ("pow2_w", {}))


def _specs(mode, kw):
    return JSpec(mode=JMode(mode), **kw), TSpec(mode=TMode(mode), **kw)


def _edge_weight(shape, seed):
    """A float weight whose per-tensor codes cover every value of
    -127..127 in each (K, N) slice (the rest seeded normal within range)."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    flat = w.reshape(-1, shape[-2] * shape[-1])
    flat[:, :255] = np.arange(-127, 128, dtype=np.float32) / 127.0
    return w


def _np(t) -> np.ndarray:
    return t.contiguous().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("mode,kw", PACK_SPECS,
                         ids=[f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
                              for m, kw in PACK_SPECS])
@pytest.mark.parametrize("shape", [(64, 48), (3, 64, 48)], ids=["2d", "stacked"])
def test_prepack_emul_weight_bit_identical(mode, kw, shape):
    jspec, tspec = _specs(mode, kw)
    w = _edge_weight(shape, seed=len(shape) + kw.get("p", 0) * 7 + kw.get("k", 0))
    jp = jqstore.prepack_emul_weight(jnp.asarray(w), jspec)
    tp = tqstore.prepack_emul_weight(torch.from_numpy(w), tspec)
    assert isinstance(tp, tqstore.PackedEmulWeight)
    assert tp.qw.dtype == torch.int8 and tp.scale.dtype == torch.float32
    assert tuple(tp.qw.shape) == shape and tuple(tp.scale.shape) == shape[:-2]
    # column-major in the last two dims: the layout torch._int_mm takes
    assert tp.qw.stride()[-2:] == (1, shape[-2])
    np.testing.assert_array_equal(_np(tp.qw), np.asarray(jp.qw))
    np.testing.assert_array_equal(_np(tp.scale), np.asarray(jp.scale))
    # the edge codes went in: every slice quantizes to the full -127..127
    raw, _ = tqstore._quantize_per_tensor_sliced(torch.from_numpy(w), 8)
    flat = raw.reshape(-1, shape[-2] * shape[-1])
    assert (flat.amax(-1) == 127).all() and (flat.amin(-1) == -127).all()


def test_int8_wrap_of_encoded_edge_codes():
    """An encoded 128 (127 perforated at p=1, or rounded at r=1/2) wraps to
    -128 in the int8 cast, as the reference's ``astype(int8)`` does."""
    codes = torch.arange(-127, 128, dtype=torch.int32)
    perf = tenc.perforate_operand(codes, 8, 1)
    rnd = tenc.round_operand(codes, 2)
    assert int(perf.max()) == 128 and int(rnd.max()) == 128
    for t, j in ((perf, jnp.asarray(np.asarray(perf))), (rnd, jnp.asarray(np.asarray(rnd)))):
        np.testing.assert_array_equal(t.to(torch.int8).numpy(),
                                      np.asarray(j.astype(jnp.int8)))
    assert int(perf.to(torch.int8)[-1]) == -128


def test_rad_k2_refused_like_the_reference():
    """k = 2 is outside the hybrid encoding's 4 <= k <= n - 2 in both."""
    jspec, tspec = _specs("rad_emul", dict(k=2))
    w = _edge_weight((32, 16), 0)
    with pytest.raises(AssertionError):
        jqstore.prepack_emul_weight(jnp.asarray(w), jspec)
    with pytest.raises(AssertionError):
        tqstore.prepack_emul_weight(torch.from_numpy(w), tspec)


#: (mode, knobs, packed): POW2_W has no pack (pack_for_spec returns the
#: float weight), so it runs on the fly only
PRODUCT_CASES = [(m, kw, packed) for m, kw in MODE_SPECS for packed in (False, True)
                 if not (packed and m == "pow2_w")]


@pytest.mark.parametrize("mode,kw,packed", PRODUCT_CASES,
                         ids=[f"{m}-{'packed' if p else 'fly'}" for m, _, p in PRODUCT_CASES])
@pytest.mark.parametrize("M", [1, 8, 255])
def test_approx_matmul_bit_identical(mode, kw, packed, M):
    jspec, tspec = _specs(mode, kw)
    rng = np.random.default_rng(M)
    K, N = 96, 40
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if packed:
        jw = jqstore.pack_for_spec(jw, jspec)
        tw = tqstore.pack_for_spec(tw, tspec)
    jy = np.asarray(jops.approx_matmul(jnp.asarray(x), jw, jspec))
    ty = tops.approx_matmul(torch.from_numpy(x), tw, tspec).numpy()
    assert ty.dtype == np.float32 and ty.shape == (M, N)
    if mode == "pow2_w":
        # an f32 float product: its snapped weights are bit-identical
        # (test_pow2_w_not_packed_and_snap_bit_identical), its sums are
        # XLA's and torch's blocked f32 GEMMs, an ulp apart (ROADMAP §C)
        np.testing.assert_allclose(ty, jy, rtol=1e-6, atol=1e-5)
    else:
        np.testing.assert_array_equal(ty, jy)


def test_pow2_w_not_packed_and_snap_bit_identical():
    jspec, tspec = _specs("pow2_w", {})
    w = np.random.default_rng(3).standard_normal((32, 24)).astype(np.float32)
    assert tqstore.pack_for_spec(torch.from_numpy(w), tspec) is not None
    assert not tqstore.is_packed(tqstore.pack_for_spec(torch.from_numpy(w), tspec))
    from repro.core import encodings as jenc

    np.testing.assert_array_equal(tenc.pow2_snap(torch.from_numpy(w)).numpy(),
                                  np.asarray(jenc.pow2_snap(jnp.asarray(w))))


def test_wrong_pack_for_spec_raises_like_the_reference():
    w = torch.randn(16, 8)
    emul = tqstore.prepack_emul_weight(w, TSpec(mode=TMode.PR_EMUL, p=1))
    axq = tqstore.prepack_weight(w, 16)
    x = torch.randn(2, 16)
    with pytest.raises(ValueError, match="AXQ spec"):
        tops.approx_matmul(x, emul, TSpec(mode=TMode.AXQ))
    with pytest.raises(ValueError, match="emul spec"):
        tops.approx_matmul(x, axq, TSpec(mode=TMode.RAD_EMUL, k=4))
    with pytest.raises(ValueError, match="POW2_W"):
        tops.approx_matmul(x, emul, TSpec(mode=TMode.POW2_W))
    with pytest.raises(ValueError, match="EXACT"):
        tops.approx_matmul(x, emul, TSpec())


@pytest.mark.parametrize("M", [1, 16, 17, 255])
def test_int_mm_padding_after_quantization(M):
    """The card's product pads a decode-sized activation to 32 rows of zero
    codes (after quantization: the pad never enters the amax) and leaves
    M > 16 alone; the CPU product equals an int64 product of the codes."""
    rng = np.random.default_rng(M)
    qx = torch.from_numpy(rng.integers(-128, 128, (M, 24)).astype(np.int8))
    qw = tqstore.emul_layout(torch.from_numpy(rng.integers(-128, 128, (24, 16)).astype(np.int8)))
    padded = tops.pad_for_int_mm(qx)
    assert padded.shape[0] == (32 if M <= 16 else M)
    assert torch.equal(padded[:M], qx) and not padded[M:].any()
    ref = qx.numpy().astype(np.int64) @ qw.contiguous().numpy().astype(np.int64)
    np.testing.assert_array_equal(tops.int_product(qx, qw).numpy(), ref)


# ---------------------------------------------------------------------------
# the model under each emulation policy
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _models(mode, kw):
    key = (mode, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jspec, tspec = _specs(mode, kw)
        jcfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
        tcfg = dataclasses.replace(tget_config(ARCH), dtype="float32")
        jm = jbuild_model(jcfg, juniform(jspec))
        tm = tbuild_model(tcfg, tuniform(tspec), device="cpu")
        jraw = jm.init(jax.random.PRNGKey(0), tp=1)
        _MODELS[key] = (jm, jraw, tm)
    return _MODELS[key]


@pytest.mark.parametrize("mode,kw", MODE_SPECS, ids=[m for m, _ in MODE_SPECS])
def test_packs_carry_across_convert(mode, kw):
    """JAX's prepacked tree converted through numpy equals the port's own
    prepack of the converted float tree, leaf for leaf (POW2_W: no pack)."""
    jm, jraw, tm = _models(mode, kw)
    jpacked = jm.prepack(jraw)
    conv = params_from_numpy(jax.tree.map(np.asarray, jpacked))
    own = tm.prepack(params_from_numpy(jax.tree.map(np.asarray, jraw)))
    lw = conv["layers"]["wq"]["w"]
    if mode == "pow2_w":
        assert not tqstore.is_packed(lw)
        return
    assert isinstance(lw, tqstore.PackedEmulWeight)
    assert lw.qw.stride()[-2:] == (1, lw.qw.shape[-2])      # the card's layout
    for key in ("wq", "wk", "wv", "wo"):
        a, b = conv["layers"][key]["w"], own["layers"][key]["w"]
        np.testing.assert_array_equal(_np(a.qw), _np(b.qw))
        np.testing.assert_array_equal(_np(a.scale), _np(b.scale))
    for key in ("up", "gate", "down"):
        a, b = conv["layers"]["mlp"][key]["w"], own["layers"]["mlp"][key]["w"]
        np.testing.assert_array_equal(_np(a.qw), _np(b.qw))
        np.testing.assert_array_equal(_np(a.scale), _np(b.scale))


@pytest.mark.parametrize("mode,kw", MODE_SPECS, ids=[m for m, _ in MODE_SPECS])
def test_forward_matches_reference(mode, kw):
    jm, jraw, tm = _models(mode, kw)
    jp = jm.prepack(jraw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(1).integers(0, 512, (2, 12)).astype(np.int32)
    jlog, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    tlog, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens.astype(np.int64))})
    jlog, tlog = np.asarray(jlog), tlog.numpy()
    assert np.isfinite(tlog).all() and tlog.shape == jlog.shape
    np.testing.assert_allclose(tlog, jlog, rtol=0, atol=1e-4)
