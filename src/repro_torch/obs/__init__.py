"""Observability of the port (metrics registry)."""
