"""The port's benchmark: one run of one cell of BENCHMARK.json (run.py)."""
