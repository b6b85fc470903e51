"""Port package hygiene: it imports neither JAX nor the reference package,
its configs equal the reference's, and its entry points run on the card
unless the caller asks for the CPU."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's tests hold it against the reference)
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_configs as tlist_configs

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def test_import_pulls_in_no_jax_and_no_reference():
    """Import repro_torch and every module under it in a fresh interpreter;
    neither jax nor repro may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=240)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_never_import_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "repro"}, f


@pytest.mark.parametrize("name", jlist_configs())
def test_configs_copy_equals_reference(name):
    assert tlist_configs() == jlist_configs()
    for n in (name, name + "-smoke"):
        assert dataclasses.asdict(tget_config(n)) == dataclasses.asdict(jget_config(n))
        assert dataclasses.asdict(tget_config(n).padded(4)) == \
            dataclasses.asdict(jget_config(n).padded(4))


def test_entry_points_need_a_card_unless_cpu(monkeypatch):
    """With no card, the CUDA defaults raise instead of running on the host;
    device='cpu' runs."""
    from repro_torch.core.approx import policy_from_flag
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_config("tinyllama-1.1b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, policy_from_flag("axq8"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_serve.main(["--arch", "tinyllama-1.1b-smoke", "--requests", "1"])
    s = launch_serve.main(["--arch", "tinyllama-1.1b-smoke", "--device", "cpu",
                           "--requests", "3", "--new-tokens", "2", "--approx",
                           "axq8", "--qos", "--slots", "2"])
    assert s["requests"] == 3 and s["generated_tokens"] == 6


def test_model_without_a_card_raises_unless_cpu(monkeypatch):
    """A ``Model`` built directly runs on the card by default: with no card
    it raises instead of quietly running on the host; device="cpu" runs."""
    from repro_torch.models.registry import Model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_config("tinyllama-1.1b-smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    m = Model(cfg, device="cpu")
    assert m.device == torch.device("cpu")
    assert m.init_cache(1, 1, 8).k.device.type == "cpu"


def test_cuda_backend_refuses_cpu_tensors():
    """REPRO_TORCH_KERNELS=cuda never runs a plain version silently."""
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.qstore import prepack_weight

    dispatch.set_backend("cuda")
    try:
        with pytest.raises(RuntimeError, match="CPU"):
            dispatch.axq_matmul(torch.zeros(2, 64), prepack_weight(torch.ones(64, 8), 64))
    finally:
        dispatch.set_backend(None)
    with pytest.raises(ValueError):
        dispatch.set_backend("pallas")
