"""Micro-benchmarks of the port (copies of ``benchmark/`` blocks)."""
