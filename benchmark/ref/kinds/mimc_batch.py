"""A batch of MiMC LongsightF322p3 preimages: the images are the public
inputs (tests/mimc.rs:31-44's hash, applied to each preimage)."""

import random

from ..bls12_381 import R


def shape(cfg) -> tuple:
    k = cfg["instances"]
    return k + 1, 2 * cfg["rounds"] * k


def publics(cfg, statement) -> list:
    rng = random.Random(cfg["constants_seed"])
    consts = [rng.randrange(R) for _ in range(cfg["rounds"])]
    out = []
    for xl, xr in zip(statement["xl"], statement["xr"]):
        for c in consts:
            t = (xl + c) % R
            xl, xr = (t * t % R * t + xr) % R, xl
        out.append(xl)
    return out
