"""Model zoo of the port (dense, MoE, SSM and hybrid families)."""

from repro_torch.models.registry import (Model, build_model, concrete_batch,  # noqa: F401
                                         input_specs)
