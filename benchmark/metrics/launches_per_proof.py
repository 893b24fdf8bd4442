"""Kernel launches a proof: the program's ``LAUNCHES`` counters
(``ops/cuda_*.py``, ``ops/ntt.py``) summed over the window."""


def read(run):
    total = sum(run.launches.values())
    return total / run.proofs if total and run.proofs else None
