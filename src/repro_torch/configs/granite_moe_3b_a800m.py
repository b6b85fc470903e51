"""IBM Granite 3.0 MoE  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8."""
from .base import ArchConfig, MoECfg, register

CONFIG = register(ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    rope_theta=10_000.0,
    moe=MoECfg(n_experts=40, top_k=8, d_expert=512),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
