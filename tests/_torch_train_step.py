"""Shared setup and helpers of the ``test_torch_train_step*.py`` files (moved out
of ``tests/test_torch_train_step.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Port parity of ``train_step`` (forward, backward, clipping, AdamW, the
cosine schedule): the same converted state and numpy batch through the JAX
reference's jitted step on its Pallas route (interpret mode) and through the
port's eager step on the CPU (the plain kernel versions forward, the
backward oracles), for the four ported families at smoke size in f32.

Tolerances (tests/_torch_train.py): loss, grad_norm and params after one
step rtol 1e-5 (atol 1e-5 on params), mu and nu within 1e-5 of each leaf's
largest entry after every step, params after 3 steps atol 1e-4.  Within the
port, remat policies and grad_accum are held to each other, and the
bf16-backward lever (REPRO_BWD_BF16) to the reference's at bf16 bounds.
"""
import numpy as np
import pytest
import torch

import _torch_train as TT
from repro.dist import collectives as jcoll
from repro_torch.dist import collectives as tcoll
from repro_torch.tree import tree_leaves
from repro_torch.train import step as tstep

torch.set_num_threads(2)

CASES = [("tinyllama-1.1b-smoke", "exact", None),
         ("tinyllama-1.1b-smoke", "axq8", 6),
         ("tinyllama-1.1b-smoke", "axq8", "vector"),
         ("granite-moe-3b-a800m-smoke", "axq8", 6),
         ("mamba2-370m-smoke", "axq8", 6),
         ("recurrentgemma-2b-smoke", "axq8", 6)]


__all__ = [
    'np',
    'pytest',
    'torch',
    'TT',
    'jcoll',
    'tcoll',
    'tree_leaves',
    'tstep',
    'CASES',
]
