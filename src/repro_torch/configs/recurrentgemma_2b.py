"""RecurrentGemma-2B (Griffin)  [arXiv:2402.19427; hf]
26L d_model=2560 10H (MQA kv=1, head_dim 256) d_ff=7680 vocab=256000,
RG-LRU + local attention, pattern (rec, rec, attn), window 2048.
Hybrid => long_500k RUNS (O(1) recurrent state + bounded local window)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    rope_theta=10_000.0,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    act="gelu",
    source="arXiv:2402.19427",
))
