"""TinyLlama-1.1B  [arXiv:2401.02385; hf]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000, llama2 arch."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab=32000,
    rope_theta=10_000.0,
    source="arXiv:2401.02385",
))
