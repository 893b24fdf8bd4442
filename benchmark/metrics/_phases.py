"""Milliseconds a proof in the prover phases whose labels start with one of
``prefixes``, from the traced run's phase hook (each phase ends in a
device sync there); None without a traced phase."""

SCOPE = "prover::"


def ms_per_proof(run, prefixes):
    total = sum(s for label, s in run.phase_s.items()
                if label.startswith(tuple(SCOPE + p for p in prefixes)))
    if not total or not run.proofs:
        return None
    return total * 1e3 / run.proofs
