"""Faults planted under the timed path, for the check's control and its
tests.  The benchmark's own runs plant none.

    with planted("control"):
        ... a run ...

* ``control``: the bulk MSMs on scalars cut to their low 248 bits, the
  nearest lower precision of the configuration's exact arithmetic mod r
  (what a shortcut in the digit windows would give);
* ``stale``: every prove does its work and returns the first proof (a
  step that returns its state unchanged);
* ``half``: each bulk MSM over the first half of its points, the rest
  left out;
* ``altered``: each proof's evaluation ``a_at_x1`` changed by one where
  the prover produces it.

The one-chip cells have no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

FAULTS = ("control", "stale", "half", "altered")


def _msm_fault(kind: str):
    from polymath_tpu_torch.ops.field import fr_from_mont
    from polymath_tpu_torch.ops.prover import LocalOps
    orig = LocalOps.msm

    def msm(self, bases, scalars, **kw):
        sc = fr_from_mont(scalars) if kw.get("mont") else scalars.clone()
        if kind == "control":
            sc[7] &= 0x00FFFFFF
        else:
            sc[:, sc.shape[1] // 2:] = 0
        return orig(self, bases, sc, **{**kw, "mont": False})

    return LocalOps, "msm", orig, msm


def _prove_fault(kind: str):
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol.api import Polymath
    orig = Polymath.prove
    first = []

    def prove(self, pk, circuit, rng=None):
        proof = orig(self, pk, circuit, rng)
        if kind == "altered":
            proof.a_at_x1 = (proof.a_at_x1 + 1) % R
        first.append(proof)
        return first[0] if kind == "stale" else proof

    return Polymath, "prove", orig, prove


@contextlib.contextmanager
def planted(kind: str):
    if kind not in FAULTS:
        raise ValueError(f"no fault {kind!r}; faults: {', '.join(FAULTS)}")
    make = _msm_fault if kind in ("control", "half") else _prove_fault
    owner, attr, orig, patched = make(kind)
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, orig)
