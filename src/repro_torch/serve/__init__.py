"""Continuous-batching serving of the port (the LM workload and the
streaming DSP workload)."""
