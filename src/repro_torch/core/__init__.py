"""Arithmetic core of the port: approximation policy, block quantization
and the runtime degree controller."""
