"""Multi-device prover: ops/prover.py's pipeline with the NTTs and MSMs
spread over a process group (counterpart of parallel/prover_sharded.py).

``create_proof_sharded`` runs ``ops/prover.py:prove`` step for step on
every rank, with ``ShardedOps`` in the place of the single-device
``LocalOps``; its phases are scoped ``prover_sharded::`` and each
collective ``collective::`` (parallel/mesh.py).

* The SAP matvecs and everything between the transforms run replicated
  on every rank, as in the reference.
* Each of the five NTTs of stage 1 is ``ntt_sharded`` (two all_to_all)
  on the column layout cut from a replicated vector; the inverse of the
  squared size-2n evaluations takes one more all_to_all (``to_columns``,
  their block layout to columns).  Each result that later steps need
  whole, u, w, wu and u^2, is gathered on the card (one all_gather each).
  So a proof takes 11 all_to_all and 4 vector all_gathers.
* The five MSMs are ``msm_sharded``: a rank's block of points, one
  window-sum all_gather each (one more if the c_w collision rerun fires).
* r_a's coefficients are drawn from each rank's Rng and broadcast from
  rank 0 (one broadcast), so ranks whose Rngs differ still make one
  proof: the one a single device makes with rank 0's Rng.
* The tail (u(x1), the D numerator, the quotient scan) runs replicated on
  the gathered vectors, on the card; nothing is pulled to the host but
  the few ints of the Fiat-Shamir rounds, as on one device.  Each rank
  then takes its block of q for the d-MSM.

Every rank holds the whole key on its device and returns the same proof,
byte-equal to ``create_proof_device``'s for the same key and Rng.
"""

from __future__ import annotations

import torch

from ..hostmath.bls12_381 import R
from ..ops.cuda_field import fr_sqr
from ..ops.field import fr_zeros
from ..ops.prover import prove
from ..protocol.data_structures import Proof
from .msm_sharded import msm_sharded
from .ntt_sharded import columns_of, gather, ntt_sharded, to_columns


class ShardedOps:
    """``ops/prover.py:LocalOps`` over the group of ``mesh``."""

    scope = "prover_sharded"

    def __init__(self, mesh):
        self.mesh = mesh
        self.device = mesh.device

    def coeffs(self, evals: torch.Tensor) -> torch.Tensor:
        m = self.mesh
        return gather(ntt_sharded(columns_of(evals, m), m, inverse=True), m)

    def square(self, u: torch.Tensor) -> torch.Tensor:
        # nested calls: ntt_sharded frees its input, which no name holds
        m, n = self.mesh, u.shape[1]
        u2_ev = fr_sqr(ntt_sharded(columns_of(
            torch.cat([u, fr_zeros(n, self.device)], dim=1), m), m))
        return gather(ntt_sharded(to_columns(u2_ev, m), m, inverse=True), m)

    def msm(self, bases, scalars, **kw):
        return msm_sharded(bases, scalars, self.mesh, **kw)

    def blinding(self, rng) -> tuple:
        draw = [rng.randrange(R), rng.randrange(R)]
        return tuple(self.mesh.broadcast_ints(draw, src=0))


def create_proof_sharded(circuit, pk, rng, transcript_cls, mesh) -> Proof:
    """Prove over ``mesh``'s group; every rank calls it and gets the same
    proof."""
    return prove(circuit, pk, rng, transcript_cls, ShardedOps(mesh))
