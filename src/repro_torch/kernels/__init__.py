"""Hand-written Hopper kernels (``csrc/*.cu``), their wrappers and plain
PyTorch versions, weight residency and the kernel dispatch."""
