"""repro_torch.train — the port of ``repro.train``: the train / eval / serve
step functions and the fault-tolerant trainer."""
