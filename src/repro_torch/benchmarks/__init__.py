"""Workload drivers of the port (the subset the tests and the GPU smoke
run need; the full benchmark driver comes later)."""
