"""Host work a proof: witness synthesis and the witness's conversion to
Montgomery words on the card (``frontend/r1cs.py``, ``ops/limbs.py``)."""

from benchmark.metrics._phases import ms_per_proof


def read(run):
    return ms_per_proof(run, ("witness synthesis", "h2d assignment"))
