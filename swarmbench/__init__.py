"""Benchmark of swarm_tpu_torch on the H100 (run.py is the entry)."""
