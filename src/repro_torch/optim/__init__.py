"""repro_torch.optim — the port of ``repro.optim`` (AdamW, clipping, the
cosine warmup schedule)."""
