"""Mamba2-370M (SSD)  [arXiv:2405.21060; unverified]
48L d_model=1024 attn-free, vocab=50280, ssm_state=128, headdim 64,
expand 2 (d_inner 2048, 32 ssd heads), chunked state-space-duality form.
SSM => long_500k RUNS (O(1) recurrent state)."""
from .base import ArchConfig, SSMCfg, register

CONFIG = register(ArchConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMCfg(d_state=128, headdim=64, expand=2, chunk=256, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
