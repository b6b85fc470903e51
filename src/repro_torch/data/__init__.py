"""repro_torch.data — the port of ``repro.data``: the seeded synthetic
token pipeline and the byte-level tokenizer (numpy only)."""
