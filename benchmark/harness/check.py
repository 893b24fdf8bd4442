"""Whether a run's output is correct, by the plain reference (``ref/``).

Compared, each against its limit (all exact, so every limit is 0):

* ``vk_differs``: 1 when the verifying key of the key the run proved with
  differs from the one the reference works out from the setup seed;
* ``proofs_rejected``: proofs of the run (warm-up and window) that the
  reference verifier rejects for their statements, whose public inputs
  the reference computes itself;
* ``proves_failed``: proves of the window that raised.
"""

from __future__ import annotations

from . import spec

LIMITS = {"vk_differs": 0, "proofs_rejected": 0, "proves_failed": 0}


def judge(cfg: dict, vk_bytes: bytes, proofs: list, proves_failed: int,
          seed: int) -> dict:
    """``proofs``: (statement key, statement, proof bytes) triples; proofs
    of one key share one statement.  Returns name -> (value, limit)."""
    from ..ref import verify
    if cfg["transcript"] != "merlin":
        raise ValueError(f"the reference verifies Merlin transcripts only, "
                         f"not {cfg['transcript']!r}")
    kind = spec.ref_kind(cfg)
    m0, constraints = kind.shape(cfg)
    vk = verify.derive_vk(cfg["setup_seed"], m0, constraints)
    statements, items = {}, []
    for key, statement, raw in proofs:
        if key not in statements:
            statements[key] = verify.Statement(kind.publics(cfg, statement))
        items.append((statements[key], raw))
    values = {"vk_differs": int(vk.to_bytes() != vk_bytes),
              "proofs_rejected": len(verify.verify_batch(vk, items, seed)),
              "proves_failed": proves_failed}
    return {k: (v, LIMITS[k]) for k, v in values.items()}


def correct(numbers: dict) -> bool:
    return all(v <= limit for v, limit in numbers.values())
