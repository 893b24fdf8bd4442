"""The 95th percentile, by nearest rank, of the window's proof latencies."""

from benchmark.harness.cell import nearest_rank


def read(run):
    return nearest_rank(run.latencies, 0.95) if run.latencies else None
