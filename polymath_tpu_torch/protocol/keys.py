"""Proving keys on disk in the reference's layouts, with numpy only
(counterpart of the reference's ``ProvingKey.save_npz`` / ``load_npz`` /
``save_dir`` / ``load_dir``, protocol/data_structures.py:195-372).

The directory store, ``save_dir(pk, path)`` / ``load_dir(path, device)``:

* ``vk.bin`` — the compressed VerifyingKey;
* ``meta.json`` — ``version`` (2; 1 is read too), ``packed``, the SAP
  dimensions, the small SRS vectors (compressed G1 hex), the COO plan
  metadata and ``true_len``;
* ``<name>_x.npy`` / ``<name>_y.npy`` — each big SRS vector as (12, N)
  uint32 words (``"packed": true``); version 1 holds (24, N) 16-bit limbs;
* ``coo_<a|b|c>_{row,col,coeff[,lvl2]}.npy`` — the COO matrices as the
  reference plans them (``ops/sparse.py:plan_segments``): int32
  (sub-)segment ids, int32 columns, (16, nnz) uint32 Montgomery 16-bit
  limbs, and the sub-segment -> row map where a row holds 2^15 entries
  or more.

``save_dir`` writes it from ``pk.device`` alone (no host points), one
vector at a time, unpadded; the reference's ``ProvingKey.load_dir`` reads
it.  ``true_len`` is each vector's row count, or the value that a loaded
key carried: a dir padded to whole MSM chunks (``tools/pkconvert.py``)
keeps its padding rows, the affine identity, through load and save.

The npz store, ``save_npz(pk, path)`` / ``load_npz(path, device)``, is the
reference's legacy single file: vk and SAP bytes, and all six SRS vectors
as (24, N) 16-bit Montgomery limbs (big vectors that the reference had
already packed are (12, N) words and are read as such).

A loaded key proves with ``Polymath.prove`` exactly as a key made by the
port's own setup: the SRS rows land in ``pk.device["srs"]`` as (N, 24)
int32 affine rows, planned COO matrices in ``pk.device["coo"]``, and the
true lengths in ``pk.device["true_len"]``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..hostmath.bls12_381 import Fq
from ..ops.curve import FW
from ..ops.limbs import FQ_SPEC, ints_to_limbs, limbs_to_ints, pack_np
from ..ops.sparse import CooMatrix, plan_segments
from ..serial import codec
from .data_structures import (
    ProvingKey, SAPDims, VerifyingKey, _PK_BIG, _PK_SMALL, _PK_VECTORS,
    sap_from_reader, sap_to_bytes,
)

#: the dir layouts load_dir reads; save_dir writes the last
VERSIONS = (1, 2)


def _rows(xs: np.ndarray, ys: np.ndarray) -> torch.Tensor:
    """x and y as (12, N) words or (24, N) 16-bit limbs -> (N, 24) int32
    affine rows (on the host)."""
    if xs.shape[0] == FQ_SPEC.L:
        xs, ys = pack_np(xs), pack_np(ys)
    words = np.concatenate([xs, ys], axis=0).view(np.int32)   # (24, N)
    return torch.from_numpy(np.ascontiguousarray(words.T))


def _limbs(words: np.ndarray) -> np.ndarray:
    """(K, ...) 32-bit words -> (2K, ...) uint32 16-bit limbs."""
    u = np.asarray(words).view(np.uint32)
    out = np.empty((2 * u.shape[0],) + u.shape[1:], np.uint32)
    out[0::2] = u & np.uint32(0xFFFF)
    out[1::2] = u >> np.uint32(16)
    return out


def _axis_words(rows: torch.Tensor, axis: int) -> np.ndarray:
    """(12, N) uint32 words of x (axis 0) or y (axis 1) of (N, 24) rows,
    transposed where the rows lie and then pulled to the host."""
    part = rows[:, axis * FW:(axis + 1) * FW].T.contiguous().cpu()
    return part.numpy().view(np.uint32)


def decode_points(xs: np.ndarray, ys: np.ndarray) -> list:
    """(24, N) 16-bit limbs of Montgomery x, y -> host affine points
    (reference data_structures.py:load_npz, ``decode``)."""
    return [(Fq(FQ_SPEC.from_mont_int(x)), Fq(FQ_SPEC.from_mont_int(y)))
            for x, y in zip(limbs_to_ints(xs), limbs_to_ints(ys))]


def coo_arrays(mat: CooMatrix):
    """A COO matrix as the reference saves it: ({row, col, coeff[, lvl2]}
    arrays, its ``meta["coo"]`` entry)."""
    sub_ids, lvl2, n_sub = plan_segments(mat.row_idx.cpu().numpy(),
                                         mat.num_rows)
    arrays = {"row": sub_ids,
              "col": mat.col_idx.cpu().numpy().astype(np.int32),
              "coeff": _limbs(mat.coeffs_mont.cpu().numpy())}
    if lvl2 is not None:
        arrays["lvl2"] = lvl2
    return arrays, {"n_sub": int(n_sub), "num_rows": mat.num_rows,
                    "num_cols": mat.num_cols, "lvl2": lvl2 is not None}


def write_dir(path: str, vk_bytes: bytes, sap_dims, small: dict, big,
              coo: dict) -> None:
    """The version-2 dir: ``small`` name -> hex points, ``big`` an iterable
    of (name, x words, y words, true length) consumed one vector at a
    time, ``coo`` tag -> CooMatrix."""
    os.makedirs(path, exist_ok=True)
    meta = {"version": 2, "packed": True, "sap_dims": list(sap_dims),
            "small": small, "coo": {}, "true_len": {}}
    with open(os.path.join(path, "vk.bin"), "wb") as fh:
        fh.write(vk_bytes)
    for name, xs, ys, true_len in big:
        np.save(os.path.join(path, name + "_x.npy"), xs)
        np.save(os.path.join(path, name + "_y.npy"), ys)
        meta["true_len"][name] = true_len
        del xs, ys
    for tag in ("a", "b", "c"):
        arrays, meta["coo"][tag] = coo_arrays(coo[tag])
        for kind, arr in arrays.items():
            np.save(os.path.join(path, f"coo_{tag}_{kind}.npy"), arr)
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def _device_srs(pk) -> dict:
    srs = pk.device.get("srs")
    if srs is None:
        raise ValueError("the proving key holds no device SRS: make it with "
                         "Polymath.setup or load it with load_dir/load_npz")
    return srs


def save_dir(pk: ProvingKey, path: str) -> None:
    """Write ``pk`` in the reference's version-2 dir layout (module
    docstring).  The COO matrices are the key's own (``pk.device["coo"]``)
    or the prover's, made from its SAP matrices where no prove made them
    yet."""
    srs = _device_srs(pk)
    coo = pk.device.get("coo")
    if coo is None:
        from ..ops.prover import get_artifacts
        art = get_artifacts(pk, srs[_PK_BIG[0]].device)
        coo = {"a": art.coo_a, "b": art.coo_b, "c": art.coo_c}
    true_len = pk.device.get("true_len", {})
    m0, m, n_r = pk.sap_matrices.m0_m_n()

    def big():
        for name in _PK_BIG:
            rows = srs[name]
            yield (name, _axis_words(rows, 0), _axis_words(rows, 1),
                   true_len.get(name, int(rows.shape[0])))

    write_dir(path, pk.vk.to_bytes(), (m0, m - m0, n_r),
              {name: [codec.g1_to_bytes(p).hex() for p in getattr(pk, name)]
               for name in _PK_SMALL}, big(), coo)


def load_dir(path: str, device) -> ProvingKey:
    """Read a version-1 or -2 dir (module docstring) onto ``device``."""
    device = torch.device(device)
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    if meta.get("version") not in VERSIONS:
        raise ValueError(f"{path}: key dir version {meta.get('version')!r}; "
                         f"versions {VERSIONS} are read")
    with open(os.path.join(path, "vk.bin"), "rb") as fh:
        vk = VerifyingKey.from_bytes(fh.read())
    sap = SAPDims(*meta["sap_dims"])
    vecs = {name: None for name in _PK_VECTORS}
    for name in _PK_SMALL:
        vecs[name] = [codec.g1_from_bytes(bytes.fromhex(h))
                      for h in meta["small"][name]]
    pk = ProvingKey(vk, sap, *[vecs[name] for name in _PK_VECTORS])
    srs = {}
    for name in _PK_BIG:
        xs = np.load(os.path.join(path, name + "_x.npy"))
        ys = np.load(os.path.join(path, name + "_y.npy"))
        srs[name] = _rows(xs, ys).to(device)
        del xs, ys
    pk.device["srs"] = srs
    pk.device["true_len"] = dict(meta.get("true_len", {}))
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


def save_npz(pk: ProvingKey, path: str) -> None:
    """Write ``pk`` as the reference's legacy npz (module docstring).  It
    needs the key's SAP matrices, which a key from load_dir does not hold
    (only their dimensions): write such a key with save_dir."""
    if getattr(pk.sap_matrices, "a", None) is None:
        raise ValueError("save_npz needs the key's SAP matrices; a key read "
                         "by load_dir holds only their dimensions")
    srs = _device_srs(pk)
    arrays = {
        "vk": np.frombuffer(pk.vk.to_bytes(), dtype=np.uint8),
        "sap": np.frombuffer(sap_to_bytes(pk.sap_matrices), dtype=np.uint8),
    }
    for name in _PK_VECTORS:
        if name in srs:
            for axis, suffix in enumerate(("_x", "_y")):
                arrays[name + suffix] = _limbs(_axis_words(srs[name], axis))
        else:
            pts = getattr(pk, name)
            for axis, suffix in enumerate(("_x", "_y")):
                arrays[name + suffix] = ints_to_limbs(
                    [0 if p is None else FQ_SPEC.to_mont_int(p[axis].v)
                     for p in pts], FQ_SPEC.L)
    np.savez(path, **arrays)


def load_npz(path: str, device) -> ProvingKey:
    """Read the reference's legacy npz onto ``device``: the big vectors
    land on the device as load_dir's do; only the small ones are decoded
    to host points."""
    device = torch.device(device)
    with np.load(path) as data:
        vk = VerifyingKey.from_bytes(data["vk"].tobytes())
        sap = sap_from_reader(codec.Reader(data["sap"].tobytes()))
        vecs = {name: None for name in _PK_VECTORS}
        for name in _PK_SMALL:
            vecs[name] = decode_points(data[name + "_x"], data[name + "_y"])
        pk = ProvingKey(vk, sap, *[vecs[name] for name in _PK_VECTORS])
        pk.device["srs"] = {
            name: _rows(data[name + "_x"], data[name + "_y"]).to(device)
            for name in _PK_BIG}
    return pk
