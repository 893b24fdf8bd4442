"""Proving keys carried across from the JAX package.

``load_dir(path, device)`` reads the directory that the reference's
``ProvingKey.save_dir`` writes, with numpy only:

* ``vk.bin`` — the compressed VerifyingKey;
* ``meta.json`` — SAP dimensions, the small SRS vectors (compressed G1
  hex), COO plan metadata;
* ``<name>_x.npy`` / ``<name>_y.npy`` — each big SRS vector as (12, N)
  uint32 words (``"packed": true``) or (24, N) 16-bit limbs (version 1);
* ``coo_<a|b|c>_{row,col,coeff[,lvl2]}.npy`` — the planned COO matrices.

The result proves with ``Polymath.prove`` exactly as a key made by the
port's own setup: SRS rows land in ``pk.device["srs"]`` as (N, 24) int32
affine rows, the COO matrices in ``pk.device["coo"]``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops.limbs import pack_np
from ..ops.sparse import CooMatrix
from ..serial import codec
from .data_structures import (
    ProvingKey, SAPDims, VerifyingKey, _PK_BIG, _PK_SMALL, _PK_VECTORS,
)


def _rows(xs: np.ndarray, ys: np.ndarray, packed: bool) -> torch.Tensor:
    if not packed:
        xs, ys = pack_np(xs), pack_np(ys)
    words = np.concatenate([xs, ys], axis=0).view(np.int32)   # (24, N)
    return torch.from_numpy(np.ascontiguousarray(words.T))


def load_dir(path: str, device) -> ProvingKey:
    device = torch.device(device)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    with open(os.path.join(path, "vk.bin"), "rb") as fh:
        vk = VerifyingKey.from_bytes(fh.read())
    sap = SAPDims(*meta["sap_dims"])
    vecs = {name: None for name in _PK_VECTORS}
    for name in _PK_SMALL:
        vecs[name] = [codec.g1_from_bytes(bytes.fromhex(h))
                      for h in meta["small"][name]]
    pk = ProvingKey(vk, sap, *[vecs[name] for name in _PK_VECTORS])
    packed = bool(meta.get("packed"))
    srs = {}
    for name in _PK_BIG:
        xs = np.load(os.path.join(path, name + "_x.npy"))
        ys = np.load(os.path.join(path, name + "_y.npy"))
        srs[name] = _rows(xs, ys, packed).to(device)
    pk.device["srs"] = srs
    coo = {}
    for tag in ("a", "b", "c"):
        cm = meta["coo"][tag]
        lvl2 = None
        if cm["lvl2"]:
            lvl2 = np.load(os.path.join(path, f"coo_{tag}_lvl2.npy"))
        coo[tag] = CooMatrix.from_arrays(
            np.load(os.path.join(path, f"coo_{tag}_row.npy")),
            np.load(os.path.join(path, f"coo_{tag}_col.npy")),
            np.load(os.path.join(path, f"coo_{tag}_coeff.npy")),
            lvl2, cm["num_rows"], cm["num_cols"], device)
    pk.device["coo"] = coo
    return pk
