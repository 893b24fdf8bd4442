"""Seconds a proof: the window's seconds over the proofs it completed."""


def read(run):
    return run.per_proof(run.window_s)
