"""Host-side rules of the flash_attention kernel's bf16 tensor-core body,
which run without a card: the 16-byte alignment rule of its ``cp.async``
copies, and the ``ptxas -v`` lines (kept with each built library) that
report every instantiation's registers and spills, head_dim 128 included.  The kernel itself is
held to its plain version on the card (tests/test_torch_gpu.py); the plain
version to the JAX Pallas kernel in tests/test_torch_kernels.py."""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tfa


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
def test_tc_view_error_accepts_the_callers_views(D):
    B, S, H, KVr = 2, 33, 8, 2
    q = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    assert tfa.tc_view_error(q, "q") is None
    # the flat entry's (BH, S, 1, D) view
    assert tfa.tc_view_error(q.reshape(B * H, S, D)[:, :, None], "q") is None
    # a grouped K/V taken every G-th head of a (B, H, S, D) tensor
    kg = q.permute(0, 2, 1, 3)[:, ::H // KVr].transpose(1, 2)
    assert tfa.tc_view_error(kg, "k") is None


def test_tc_view_error_refuses_misaligned_views():
    base = torch.zeros(2, 16, 4, 72, dtype=torch.bfloat16)
    msg = tfa.tc_view_error(base[..., 1:65], "q")
    assert msg is not None and "pointer" in msg
    msg = tfa.tc_view_error(torch.zeros(2, 16, 4, 68, dtype=torch.bfloat16)[..., :64], "k")
    assert msg is not None and "head stride of 136 bytes" in msg
    # a sequence stride of 3 rows of 40 bytes: 120 bytes
    x = torch.zeros(2, 48, 1, 20, dtype=torch.bfloat16)[:, ::3, :, :16]
    assert "seq stride" in tfa.tc_view_error(x, "v")


def test_tc_view_error_ignores_strides_of_length_one_dims():
    x = torch.zeros(1, 16, 1, 64, dtype=torch.bfloat16).as_strided(
        (1, 16, 1, 64), (3, 64, 5, 1))
    assert tfa.tc_view_error(x, "q") is None


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115flash_tc_kernelILi80EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115flash_tc_kernelILi80EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compile time = 1425.618 ms
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_116flash_fwd_kernelIfLi64EEEvPKT_
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 220 registers, used 1 barriers, 8256 bytes smem
"""


def test_kernel_resources_parses_ptxas():
    rows = _build.kernel_resources(PTXAS.splitlines())
    assert len(rows) == 2
    assert "flash_tc_kernelILi80E" in rows[0]["function"]
    assert "flash_fwd_kernelIfLi64E" in rows[1]["function"]
    assert (rows[0]["registers"], rows[0]["spill_stores"], rows[0]["spill_loads"],
            rows[0]["smem"]) == (168, 0, 0, 0)
    assert (rows[1]["registers"], rows[1]["spill_stores"], rows[1]["spill_loads"],
            rows[1]["smem"]) == (220, 12, 16, 8256)
    assert _build.kernel_resources(["ptxas info    : 0 bytes gmem"]) == []


#: the head_dim-128 instantiations' lines as ptxas -v prints them for this
#: source (anonymous-namespace prefix included), with a spill on the second
PTXAS_128 = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea716flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PiNS_4PlanENS_7StridesES7_S7_f' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea716flash_fwd_kernelIfLi128EEEvPKT_S3_S3_PS1_PiNS_4PlanENS_7StridesES7_S7_f
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers, 16448 bytes smem
ptxas info    : Compile time = 685.750 ms
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea715flash_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_PiNS_4PlanENS_7StridesES7_S7_f' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea715flash_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PS1_PiNS_4PlanENS_7StridesES7_S7_f
    96 bytes stack frame, 96 bytes spill stores, 108 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


@pytest.mark.parametrize("which,expect", [
    (0, (("fwd", "f32", 128), 254, 0, 0, 16448)),
    (1, (("tc", "bf16", 128), 128, 96, 108, 0))], ids=["f32-128", "bf16-128"])
def test_kernel_resources_parses_head_dim_128_lines(which, expect):
    """The D = 128 instantiations of both bodies: registers, spills and
    static shared memory, and the (body, dtype, D) that phase 1 of
    chip_smoke.py names them by and counts."""
    r = _build.kernel_resources(PTXAS_128.splitlines())[which]
    assert (_build.flash_instance(r["function"]), r["registers"], r["spill_stores"],
            r["spill_loads"], r["smem"]) == expect


def test_flash_instance_names_every_body_and_ignores_others():
    rows = _build.kernel_resources(PTXAS.splitlines())
    assert [_build.flash_instance(r["function"]) for r in rows] == [
        ("tc", "bf16", 80), ("fwd", "f32", 64)]
    assert _build.flash_instance("_ZN12_GLOBAL__N_113decode_kernelI8Int8RowsEEvT_") is None
    assert _build.flash_instance(
        "_ZN12_GLOBAL__N_116flash_fwd_kernelI13__nv_bfloat16Li32EEEvPKT_") == (
            "fwd", "bf16", 32)


def test_cached_build_keeps_its_ptxas_lines(tmp_path, monkeypatch):
    """A library found in the build directory reports the ptxas lines of the
    build that made it (chip_smoke's spill gate reads them on every run),
    and a library without them is built again.  A stand-in nvcc writes the
    output file and one ptxas line; nothing is loaded."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo x >> {calls}\n"
        "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        ": > \"$out\"\n"
        "echo \"ptxas info    : Used 7 registers, used 1 barriers\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_load", lambda name, path: path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "ptxas_log", {})
    _build.build_all()
    first = dict(_build.ptxas_log)
    assert first["flash_attention"] == ["ptxas info    : Used 7 registers, used 1 barriers"]
    n_built = len(calls.read_text().split())
    assert n_built == len(_build.SOURCES)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "ptxas_log", {})
    _build.build_all()                        # every library cached
    assert _build.ptxas_log == first
    assert len(calls.read_text().split()) == n_built
    next((tmp_path / "kernels").glob("libflash_attention-*.ptxas")).unlink()
    monkeypatch.setattr(_build, "_libs", {})
    _build.build_all()                        # its log lost: built again
    assert len(calls.read_text().split()) == n_built + 1
    assert _build.ptxas_log["flash_attention"] == first["flash_attention"]


def test_build_variants_builds_each_edit_and_use_swaps_it_in(tmp_path, monkeypatch):
    """The tuning tools' variant builder writes each edited source, runs one
    nvcc for each (a stand-in that copies the source to the library and
    prints one ptxas line), returns each library with its own ptxas lines,
    and ``use`` makes one the library the wrappers launch."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        "while [ $# -gt 1 ]; do [ \"$1\" = -o ] && out=$2; shift; done\n"
        "cp \"$1\" \"$out\"\n"
        "echo \"ptxas info    : Used $(cat \"$1\") registers\"\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_load", lambda name, path: (name, path.read_text()))
    monkeypatch.setattr(_build, "_libs", {})
    built = _build.build_variants("flash_decode", {"w64": "64", "w128": "128"},
                                  tmp_path / "tune")
    assert built == {
        "w64": (("flash_decode", "64"), ["ptxas info    : Used 64 registers"]),
        "w128": (("flash_decode", "128"), ["ptxas info    : Used 128 registers"])}
    assert (tmp_path / "tune" / "flash_decode_w64.cu").read_text() == "64"
    _build.use("flash_decode", built["w128"][0])
    assert _build._libs == {"flash_decode": ("flash_decode", "128")}
    nvcc.write_text("#!/bin/sh\necho 'error: no'\nexit 2\n")
    with pytest.raises(RuntimeError, match="flash_decode bad"):
        _build.build_variants("flash_decode", {"bad": "x"}, tmp_path / "tune")
