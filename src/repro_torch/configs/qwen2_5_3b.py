"""Qwen2.5-3B  [hf:Qwen/Qwen2.5-0.5B family; hf]
36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, QKV bias."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    source="hf:Qwen/Qwen2.5-3B",
))
