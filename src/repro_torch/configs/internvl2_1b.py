"""InternVL2-1B  [arXiv:2404.16821; hf]
LM backbone (Qwen2-0.5B): 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655.  Vision frontend (InternViT) is a STUB per the assignment:
input_specs() provides precomputed patch embeddings (frontend_dim=1024),
projected by a 2-layer MLP and prepended to the text sequence."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab=151655,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    frontend="vision",
    frontend_dim=1024,
    frontend_tokens=1024,
    source="arXiv:2404.16821",
))
