"""The protocol's polynomial work a proof on the card: matvecs, NTTs and
h (stage1), the D numerator (stage2a) and the quotient scan (stage2b)."""

from benchmark.metrics._phases import ms_per_proof


def read(run):
    return ms_per_proof(run, ("stage1", "stage2a", "stage2b"))
