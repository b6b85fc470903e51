"""Model zoo of the port (dense transformer family)."""

from repro_torch.models.registry import Model, build_model  # noqa: F401
