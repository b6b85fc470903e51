"""HuBERT X-Large  [arXiv:2106.07447; unverified]
48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (k-means units),
encoder-only (bidirectional); audio conv frontend is a STUB: input_specs()
provides precomputed 512-d frame features.  No decode shapes (encoder)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    frontend="audio",
    frontend_dim=512,
    act="gelu",
    source="arXiv:2106.07447",
))
