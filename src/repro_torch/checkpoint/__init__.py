"""repro_torch.checkpoint — the port of ``repro.checkpoint``."""
