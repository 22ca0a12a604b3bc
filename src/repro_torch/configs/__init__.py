"""Workload configurations of the port (seeded numpy generators)."""
