"""Continuous-batching serving of the port (LM workload)."""
