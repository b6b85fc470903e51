"""Mistral-Nemo-Base-2407 (12B)  [hf:mistralai/Mistral-Nemo-Base-2407; hf]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, 128k ctx."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=131072,
    rope_theta=1_000_000.0,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
))
