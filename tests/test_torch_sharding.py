"""Port parity of the partition rules (``repro_torch.dist.sharding``)
against ``repro.dist.sharding``, and the slicing of trees to a rank's
shards, on the CPU with no process group (a rank's :class:`Mesh` is built
for its coordinate directly).

Held to the reference exactly: the spec of every leaf of every arch's real
parameter tree (the reference's ``jax.eval_shape`` of its init, the port's
init on the meta device), of its decode cache and of a batch.  Then: the tp
local shards of a smoke tree concatenate back into each global leaf bit for
bit (QKV biases sliced with their columns); a pack built on an aligned
shard equals the matching slice of the global pack, row- and
column-parallel; a row-parallel shard that is not a whole number of AXQ
blocks raises, naming its leaf (tinyllama-1.1b's down at tp=4, internvl2-1b's
wo at tp=2)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.dist import sharding as jsharding
from repro.models import build_model as jbuild_model
from repro_torch.configs import get_config, list_configs
from repro_torch.core.approx import ApproxMode, ApproxSpec, policy_from_flag, uniform
from repro_torch.dist import meshctx, sharding
from repro_torch.kernels.qstore import PackedQWeight, prepack_params
from repro_torch.models import rglru, ssm, transformer
from repro_torch.tree import named_leaves

torch.set_num_threads(2)


def _jax_specs(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jsharding._key_str(k) for k in path): tuple(spec) for path, spec in flat}


def _port_specs(tree) -> dict:
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(t, tuple) and hasattr(t, "_fields"):
            for k, v in zip(t._fields, t):
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            out[path] = t

    walk(tree, "")
    return out


def _port_init(cfg, device="meta"):
    gen = torch.Generator()
    if cfg.family == "hybrid":
        return rglru.init_hybrid(gen, cfg, 1, device)
    if cfg.family == "ssm":
        return ssm.init_ssm_lm(gen, cfg, 1, device)
    return transformer.init_lm(gen, cfg, 1, device)


def _port_cache(cfg):
    if cfg.family == "hybrid":
        return rglru.init_hybrid_cache(cfg, 1, 2, 64, device="meta")
    if cfg.family == "ssm":
        return ssm.init_ssm_cache(cfg, 1, 2, 64, device="meta")
    return transformer.init_lm_cache(cfg, 1, 2, 64, device="meta")


@pytest.mark.parametrize("arch", list_configs())
def test_specs_match_reference_on_real_trees(arch):
    """Every leaf's spec on the arch's real parameter tree, its cache's and
    a batch's, equal the reference's, entry for entry."""
    jm = jbuild_model(jget_config(arch))
    jp = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), tp=1))
    cfg = get_config(arch)
    tp_ = _port_init(cfg)
    want = _jax_specs(jsharding.partition_params(jp))
    got = _port_specs(sharding.partition_params(tp_))
    assert got == want
    assert {n for n, _ in named_leaves(tp_)} == set(want)
    if not cfg.encoder_only:
        jc = jax.eval_shape(lambda: jm.init_cache(1, 2, 64))
        assert _port_specs(sharding.partition_cache(_port_cache(cfg))) == \
            _jax_specs(jsharding.partition_cache(jc))
    jb = {"tokens": jax.ShapeDtypeStruct((2, 8), jnp.int32),
          "labels": jax.ShapeDtypeStruct((2, 8), jnp.int32)}
    tb = {"tokens": torch.empty((2, 8), device="meta"),
          "labels": torch.empty((2, 8), device="meta")}
    assert _port_specs(sharding.partition_batch(tb)) == _jax_specs(jsharding.partition_batch(jb))


def _rank_mesh(tp, r):
    return meshctx.Mesh((1, tp), ("data", "model"), rank=r)


def _concat(parts, spec):
    dims = [d for d, e in enumerate(spec) if e == "model"]
    if not dims:
        assert all(torch.equal(p, parts[0]) for p in parts)
        return parts[0]
    return torch.cat(parts, dim=dims[0])


@pytest.mark.parametrize("arch,tp", [("tinyllama-1.1b-smoke", 2), ("tinyllama-1.1b-smoke", 4),
                                     ("granite-moe-3b-a800m-smoke", 2),
                                     ("qwen2.5-3b-smoke", 2), ("qwen2-moe-a2.7b-smoke", 2)])
def test_shards_concatenate_to_the_global_leaves(arch, tp):
    """The tp ranks' shards of every leaf concatenate (along the sharded
    dim) into the global leaf bit for bit; replicated leaves are whole on
    every rank; a column-parallel QKV bias is sliced with its columns."""
    cfg = get_config(arch)
    params = transformer.init_lm(torch.Generator().manual_seed(3), cfg, tp)
    gen = torch.Generator().manual_seed(4)
    for key in ("wq", "wk", "wv"):
        if "b" in params["layers"][key]:
            params["layers"][key]["b"] = torch.randn(params["layers"][key]["b"].shape,
                                                     generator=gen)
    specs = sharding.partition_params(params)
    shards = [sharding.shard_params(params, specs, _rank_mesh(tp, r)) for r in range(tp)]
    flat = dict(named_leaves(params))
    sflat = _port_specs(specs)
    per_rank = [dict(named_leaves(s)) for s in shards]
    for name, leaf in flat.items():
        parts = [pr[name] for pr in per_rank]
        spec = sflat[name]
        if name.endswith("/b") and cfg.qkv_bias and name.split("/")[-2] in ("wq", "wk", "wv"):
            spec = (None,) * (leaf.dim() - 1) + ("model",)
            assert parts[0].shape[-1] * tp == leaf.shape[-1]
        assert torch.equal(_concat(parts, spec), leaf), name
    if cfg.moe:
        E = params["layers"]["moe"]["experts"]["up"].shape[1]
        assert per_rank[0]["layers/moe/experts/up"].shape[1] == E // tp


def test_shard_params_refuses_packed_leaves_and_uneven_dims():
    cfg = get_config("tinyllama-1.1b-smoke")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, 1)
    packed = prepack_params(params, cfg, policy_from_flag("axq8"), tp=1)
    with pytest.raises(ValueError, match="pack after sharding|shard the float tree"):
        sharding.shard_params(packed, mesh=_rank_mesh(2, 0))
    with pytest.raises(ValueError, match="does not split into 3 shards"):
        sharding.shard_leaf(torch.zeros(4, 5), (None, "model"), _rank_mesh(3, 0), "x")


@pytest.mark.parametrize("tp", [2, 4])
def test_pack_on_an_aligned_shard_is_the_global_pack_sliced(tp):
    """AXQ at block 16 (the smoke's K shards 64 / tp and 128 / tp are whole
    blocks): each rank's packs equal the matching slices of the global
    packs — wq / up / gate / unembed along N, wo / down along K — codes and
    scales bit for bit."""
    cfg = get_config("tinyllama-1.1b-smoke")
    policy = uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=8, block=16))
    params = transformer.init_lm(torch.Generator().manual_seed(1), cfg, tp)
    glob = prepack_params(params, cfg, policy, tp=1)
    for r in range(tp):
        local = prepack_params(sharding.shard_params(params, mesh=_rank_mesh(tp, r)), cfg,
                               policy, tp=tp)
        for key, axis in (("wq", "n"), ("wk", "n"), ("wo", "k")):
            g, l = glob["layers"][key]["w"], local["layers"][key]["w"]
            assert isinstance(l, PackedQWeight) and l.block == g.block == 16
            _check_slice(g, l, axis, r, tp)
        for key, axis in (("up", "n"), ("gate", "n"), ("down", "k")):
            _check_slice(glob["layers"]["mlp"][key]["w"], local["layers"]["mlp"][key]["w"],
                         axis, r, tp)
        _check_slice(glob["unembed"]["w"], local["unembed"]["w"], "n", r, tp)


def _check_slice(g: PackedQWeight, l: PackedQWeight, axis: str, r: int, tp: int):
    if axis == "n":
        n = g.n // tp
        assert torch.equal(l.qw, g.qw[..., r * n:(r + 1) * n, :])
        assert torch.equal(l.scales, g.scales[..., r * n:(r + 1) * n, :])
    else:
        k, kb = g.k // tp, g.scales.shape[-1] // tp
        assert torch.equal(l.qw, g.qw[..., r * k:(r + 1) * k])
        assert torch.equal(l.scales, g.scales[..., r * kb:(r + 1) * kb])


@pytest.mark.parametrize("arch,tp,leaf", [("tinyllama-1.1b", 4, "layer/mlp/down/w"),
                                          ("internvl2-1b", 2, "layer/wo/w")])
def test_misaligned_row_shard_raises(arch, tp, leaf):
    """tinyllama-1.1b's down at tp=4 (K 5632 / 4 = 1408 = 5.5 blocks of
    256) and internvl2-1b's wo at tp=2 (K 896 / 2 = 448 = 3.5 blocks of
    128) raise, naming the leaf, before any shard is quantized with other
    blocks than one device's (shapes only: the meta device)."""
    cfg = get_config(arch)
    params = transformer.init_lm(torch.Generator(), cfg, tp, device="meta")
    local = sharding.shard_params(params, mesh=_rank_mesh(tp, 0))
    with pytest.raises(ValueError, match=f"{leaf}: the row-parallel shard.*not a whole "
                                         "number of AXQ blocks"):
        prepack_params(local, cfg, policy_from_flag("axq8"), tp=tp)


def test_emul_packs_refuse_a_mesh():
    cfg = get_config("tinyllama-1.1b-smoke")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, 2)
    local = sharding.shard_params(params, mesh=_rank_mesh(2, 1))
    spec = ApproxSpec(mode=ApproxMode.PR_EMUL, p=1, r=2)
    with pytest.raises(NotImplementedError, match="per-tensor scale"):
        prepack_params(local, cfg, uniform(spec), tp=2)


def test_partition_opt_state_mirrors_the_params():
    from repro_torch.optim import adamw

    cfg = get_config("tinyllama-1.1b-smoke")
    params = transformer.init_lm(torch.Generator().manual_seed(0), cfg, 1)
    specs = sharding.partition_params(params)
    st = sharding.partition_opt_state(adamw.init(params), specs)
    assert st.step == () and st.mu is specs and st.nu is specs
    assert st.mu["layers"]["wo"]["w"] == (None, "model", None)
    assert st.mu["layers"]["wq"]["w"] == (None, None, "model")
    assert st.mu["embed"]["emb"] == ("model", None)
    assert st.mu["layers"]["ln1"]["scale"] == (None, None)


def test_rank_meshes_lay_out_row_major():
    m = meshctx.Mesh((2, 3), ("data", "model"), rank=4)
    assert (m.coord("data"), m.coord("model"), m.size("model"), m.size("data")) == (1, 1, 3, 2)
    assert meshctx.batch_axes(m) == ("data",)
    with pytest.raises(ValueError, match="must include 'model'"):
        meshctx.make_mesh((1, 1), ("data", "x"))
    assert meshctx.get_mesh().shape == (1, 1) and meshctx.model_size() == 1
    with meshctx.use_mesh(m):
        assert meshctx.model_size() == 3
    assert meshctx.model_size() == 1


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_cache_shards_are_a_ranks_cache(quant):
    """``shard_cache`` cuts a global cache into the kv heads a rank holds:
    the shards concatenate back along the heads, and each has the shape
    of the cache a rank builds itself (``init_lm_cache`` on its mesh)."""
    cfg = get_config("tinyllama-1.1b-smoke")
    gen = torch.Generator().manual_seed(2)
    glob = transformer.init_lm_cache(cfg, 2, 3, 16, quant=quant)
    glob = type(glob)(*(torch.randn(t.shape, generator=gen).to(t.dtype) if t.dim() > 1
                        else t for t in glob))
    parts = [sharding.shard_cache(glob, mesh=_rank_mesh(2, r)) for r in range(2)]
    for name, leaf in zip(glob._fields, glob):
        got = [getattr(p, name) for p in parts]
        if leaf.dim() > 1:
            assert torch.equal(torch.cat(got, dim=3), leaf), name
        else:
            assert all(torch.equal(g, leaf) for g in got), name
    with meshctx.use_mesh(_rank_mesh(2, 1)):
        own = transformer.init_lm_cache(cfg, 2, 3, 16, quant=quant)
    assert [t.shape for t in own] == [t.shape for t in parts[1]]


def test_in_proj_is_cut_by_its_parts():
    """mamba2-370m-smoke at tp=2 (the reference's tree, through numpy):
    rank r's in_proj is the reference's columns ``[z_r | x_r | B | C |
    dt_r]`` (z, x and dt cut by heads, B and C whole), its conv channels
    ``[x_r | B | C]``, its dt_bias / a_log / D the heads' and gnorm the
    channels'; out_proj the heads' rows."""
    import numpy as np

    from repro_torch.convert import params_from_numpy

    arch, tp = "mamba2-370m-smoke", 2
    jm = jbuild_model(jget_config(arch))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), tp=tp))
    cfg = get_config(arch)
    d_in, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    H = d_in // cfg.ssm.headdim
    L = tree["layers"]
    for r in range(tp):
        local = sharding.shard_params(params_from_numpy(tree), mesh=_rank_mesh(tp, r))["layers"]
        heads = lambda a, n: a[..., r * n // tp:(r + 1) * n // tp]
        w = L["in_proj"]["w"]
        z, x, bc, dt = (w[..., :d_in], w[..., d_in:2 * d_in],
                        w[..., 2 * d_in:2 * d_in + 2 * N], w[..., 2 * d_in + 2 * N:])
        want = np.concatenate([heads(z, d_in), heads(x, d_in), bc, heads(dt, H)], -1)
        assert np.array_equal(local["in_proj"]["w"].numpy(), want)
        for k in ("w", "b"):
            c = L["conv"][k]
            want = np.concatenate([heads(c[..., :d_in], d_in), c[..., d_in:]], -1)
            assert np.array_equal(local["conv"][k].numpy(), want)
        for k in ("dt_bias", "a_log", "D"):
            assert np.array_equal(local[k].numpy(), heads(L[k], H))
        assert np.array_equal(local["gnorm"]["scale"].numpy(), heads(L["gnorm"]["scale"], d_in))
        assert np.array_equal(local["out_proj"]["w"].numpy(),
                              L["out_proj"]["w"][:, r * d_in // tp:(r + 1) * d_in // tp])


def _random_like(tree, seed):
    import numpy as np

    from repro_torch.tree import tree_map

    rng = np.random.default_rng(seed)
    return tree_map(lambda t: rng.standard_normal(t.shape).astype(np.float32)
                    if t.is_floating_point() else t.numpy(), tree)


@pytest.mark.parametrize("tp", [2, 4])
def test_shard_then_gather_is_the_identity_on_recurrent_trees(tp, tmp_path):
    """Both recurrent families' parameter trees and caches (random contents,
    the shapes of the tp-padded trees) cut to each rank of a (1, tp) mesh
    and gathered back bit for bit (spawned gloo ranks); each rank's cache
    part has the shape of the cache it builds itself."""
    import numpy as np

    import _torch_mesh as M
    from repro_torch.tree import tree_leaves

    trees, caches, own = [], [], []
    for arch in ("mamba2-370m-smoke", "recurrentgemma-2b-smoke"):
        cfg = get_config(arch)
        init = rglru.init_hybrid if cfg.family == "hybrid" else ssm.init_ssm_lm
        make = rglru.init_hybrid_cache if cfg.family == "hybrid" else ssm.init_ssm_cache
        trees.append(_random_like(init(torch.Generator().manual_seed(0), cfg, tp), 1))
        glob = make(cfg, tp, 3, 16, dtype=torch.float32)
        caches.append(type(glob)(*(_random_like(glob, 2))))
        with meshctx.use_mesh(_rank_mesh(tp, 1)):
            own.append({n: tuple(v.shape) for n, v in named_leaves(make(cfg, tp, 3, 16))})
    ranks = meshctx.spawn_ranks(M.roundtrip_rank, tp, store_dir=str(tmp_path),
                                timeout_s=M.TIMEOUT_S, args=(trees, caches))
    for r in ranks:
        for got, want in zip(r["trees"] + r["caches"], trees + caches):
            for a, b in zip(tree_leaves(got), tree_leaves(want)):
                assert np.array_equal(a, b)
    assert ranks[1]["shapes"][2:] == own
    in_proj = ranks[0]["shapes"][0]["layers/in_proj/w"]
    assert in_proj[-1] == (296 - 32) // tp + 32           # [z_r | x_r | B | C | dt_r]
