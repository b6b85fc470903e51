"""The port's dry run (``repro_torch.launch.dryrun``): the reference's
``--list`` table line for line, two cells traced in process against the
shard sizes and FLOPs computed from their configs, and the error path.

* ``tinyllama-1.1b x decode_32k`` on pod16x16: rank 0 holds 8 of the 128
  slots, 2 of the 32 query heads and one of the 16 repeated kv heads, a
  1/16 column or row cut of every projection and of the vocab;
  ``serve_step`` on its float (f32) parameters and bf16 cache.
* ``mamba2-370m x long_500k`` on pod2x16x16: the one row on rank 0 (the
  global batch is smaller than the 32 data ranks), 2 of the 32 SSD heads,
  ``in_proj`` cut part by part (``[z_r | x_r | B | C | dt_r]``), the tied
  vocab-parallel unembedding.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get_config
from repro_torch.launch import dryrun

ROOT = Path(__file__).resolve().parents[1]


def test_list_prints_the_reference_table():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    ref = subprocess.run([sys.executable, "-m", "repro.launch.dryrun", "--list"], env=env,
                         capture_output=True, text=True, check=True, timeout=120).stdout
    assert dryrun.list_lines() == ref.splitlines()
    assert len(ref.splitlines()) == len(dryrun.ARCHS) == 10


def _dense_decode(cfg, tp, rows, T):
    """(argument bytes, dot FLOPs) of a dense arch's decode step on one
    rank of a tp-wide model axis (no QKV bias, untied, f32 weights, bf16
    cache, int32 tokens)."""
    pd = cfg.padded(tp)
    d, L, D = cfg.d_model, cfg.n_layers, cfg.head_dim
    q, kv, f, v = pd.n_heads * D // tp, cfg.n_kv_heads * D // tp, pd.d_ff // tp, pd.vocab // tp
    layer = d * q + 2 * d * kv + q * d + 3 * d * f + 2 * d
    params = 4 * (v * d + L * layer + d + d * v)
    cache = 2 * L * rows * T * (pd.n_kv_rep // tp) * D * 2 + 4 * rows
    heads = pd.n_heads // tp
    flops = L * 2 * rows * (d * q + 2 * d * kv + q * d + 3 * d * f) \
        + L * 2 * 2 * rows * heads * T * D + 2 * rows * d * v
    return params + cache + 4 * rows, flops


def _ssm_decode(cfg, tp, rows):
    """The same for the Mamba-2 family (tied embeddings, f32 state)."""
    s, d, L = cfg.ssm, cfg.d_model, cfg.n_layers
    d_in = s.expand * d
    H, P, N = d_in // s.headdim, s.headdim, s.d_state
    h, xin, v = H // tp, d_in // tp, cfg.padded(tp).vocab // tp
    proj = 2 * xin + 2 * N + h                    # [z_r | x_r | B | C | dt_r]
    conv = xin + 2 * N
    layer = d + d * proj + s.conv_width * conv + conv + 3 * h + xin + xin * d
    params = 4 * (v * d + L * layer + d)
    state = 4 * L * rows * h * P * N + 2 * L * rows * (s.conv_width - 1) * conv + 4 * rows
    flops = L * 2 * rows * (d * proj + xin * d + h * P * N) + 2 * rows * d * v
    return params + state + 4 * rows, flops


@pytest.mark.parametrize("cell", ["tinyllama-1.1b/decode_32k/single",
                                  "mamba2-370m/long_500k/multi"])
def test_cells_trace_at_their_shard_sizes(cell):
    arch, shape, pods = cell.split("/")
    rec = dryrun.run_cell(arch, shape, pods == "multi")
    assert rec["status"] == "ok"
    cfg = get_config(arch)
    rows = max(1, rec["global_batch"] // (rec["chips"] // rec["tp"]))
    if cfg.family == "ssm":
        want_bytes, want_flops = _ssm_decode(cfg, rec["tp"], rows)
    else:
        want_bytes, want_flops = _dense_decode(cfg, rec["tp"], rows, rec["seq"])
    assert (rec["chips"], rec["tp"], rows) == ((512, 16, 1) if pods == "multi" else (256, 16, 8))
    assert rec["memory"]["argument_bytes"] == want_bytes
    h = rec["hlo_analysis"]
    assert h["dot_flops"] == h["dot_flops_by_dtype"]["f32"] == want_flops
    assert h["while_trip_counts"] == {}
    # the vocab-parallel embedding's sum, then two a layer: wo's and down's
    # row-parallel partials, or out_proj's and the gated norm's sum of
    # squares over model; the logits stay vocab-sharded
    ar = h["collectives"]["calls_by_kind"]["all-reduce"]
    assert ar == 2 * cfg.n_layers + 1
    assert math.isclose(h["collectives"]["total_bytes"],
                        sum(h["collectives"]["by_kind"].values()))
    assert set(rec) >= {"trace_s", "memory", "hlo_analysis", "params_total", "kind"}


def test_an_error_cell_is_recorded_and_all_exits_1(monkeypatch, tmp_path, capsys):
    """A cell that raises writes ``status: "error"`` with the traceback and
    exits 1; ``--all`` runs each cell in a subprocess and exits 1 listing
    the ones that failed."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)

    def boom(*a, **k):
        raise RuntimeError("shard does not split")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--tag", "t"])
    assert e.value.code == 1
    rec = json.loads((tmp_path / "pod16x16__t" / "tinyllama-1.1b__train_4k.json").read_text())
    assert rec["status"] == "error" and "shard does not split" in rec["error"]

    ran = []

    def fake_run(cmd, cwd):
        ran.append(cmd)
        bad = cmd[cmd.index("--arch") + 1] == "hubert-xlarge" and "--multi-pod" in cmd
        return subprocess.CompletedProcess(cmd, 1 if bad else 0)

    monkeypatch.setattr(dryrun.subprocess, "run", fake_run)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--all", "--multi-pod", "--shape", "train_4k"])
    assert e.value.code == 1
    assert len(ran) == len(dryrun.ARCHS) * len(dryrun.SHAPE_NAMES)
    out = capsys.readouterr().out
    assert "FAILURES:" in out and "('hubert-xlarge', 'train_4k', True)" in out
