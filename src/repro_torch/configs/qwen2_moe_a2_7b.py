"""Qwen1.5-MoE-A2.7B  [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=151936, MoE 60e top-4,
4 shared experts (assignment spec)."""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    moe=MoECfg(n_experts=60, top_k=4, d_expert=1408, n_shared=4, d_shared=1408),
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
