"""PyTorch/CUDA port of the ``repro`` approximate-serving stack.

The package mirrors ``repro``'s module names (``repro_torch.kernels.axqmm``
ports ``repro.kernels.axqmm`` and so on) and holds the same arithmetic: AXQ
block-quantized GEMMs with a runtime effective-bits degree, flash prefill and
decode attention, the dense transformer LM and the continuous-batching serve
engine.  Every Pallas kernel on the serving path is a CUDA C++ kernel for
Hopper (``kernels/csrc``) with a plain PyTorch version beside it.

It imports ``torch`` and numpy only — never ``jax`` and never ``repro``.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card they raise instead of falling back.
"""
