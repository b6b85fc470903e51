"""H2O-Danube-1.8B  [arXiv:2401.16818; hf]
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, llama+mistral mix,
sliding-window attention (window 4096) => sub-quadratic decode; long_500k RUNS."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    rope_theta=10_000.0,
    swa_window=4096,
    source="arXiv:2401.16818",
))
