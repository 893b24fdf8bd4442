"""A proving key's npz file -> its dir, on the host with numpy only
(counterpart of the reference's tools/pkconvert.py).

    python3 -m polymath_tpu_torch.tools.pkconvert in.npz [outdir]

Reads the legacy npz (``protocol/keys.py:save_npz``, or the reference's
``ProvingKey.save_npz``) and writes the version-2 dir that ``load_dir`` of
either package reads, as the reference's converter does: each big vector
padded with (0, 0) rows (the affine identity) to whole chunks of
``ops/msm.py:default_chunk()`` (``POLYMATH_MSM_CHUNK``) and packed to
(12, N) words, ``true_len`` its unpadded length, the COO matrices planned
from the SAP matrices.  ``outdir`` defaults to ``in.npz`` with ``.dir``
for ``.npz``.  Nothing touches a device.

``main(argv=None) -> dict`` returns (and prints as one JSON line) the dir
and each vector's points and padding.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..ops.limbs import FQ_SPEC, pack_np
from ..ops.msm import default_chunk
from ..ops.sparse import CooMatrix
from ..protocol.data_structures import _PK_BIG, _PK_SMALL, sap_from_reader
from ..protocol.keys import decode_points, write_dir
from ..serial import codec


def _padded_words(arr: np.ndarray, chunk: int) -> np.ndarray:
    """(24, N) limbs or (12, N) words -> (12, N + pad) uint32 words, N +
    pad a whole number of chunks."""
    pad = (-arr.shape[-1]) % chunk
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((arr.shape[0], pad), arr.dtype)], axis=1)
    if arr.shape[0] == FQ_SPEC.L:
        arr = pack_np(arr)
    return arr.view(np.uint32)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("npz")
    ap.add_argument("out", nargs="?")
    args = ap.parse_args(argv)
    out = args.out or args.npz[:-len(".npz")] + ".dir"
    chunk = default_chunk()
    report = {"out": out, "chunk": chunk, "vectors": {}}
    with np.load(args.npz) as data:
        sap = sap_from_reader(codec.Reader(data["sap"].tobytes()))
        m0, m, n_r = sap.m0_m_n()
        small = {name: [codec.g1_to_bytes(p).hex() for p in decode_points(
                     data[name + "_x"], data[name + "_y"])]
                 for name in _PK_SMALL}

        def big():
            for name in _PK_BIG:
                xs, ys = data[name + "_x"], data[name + "_y"]
                n_pts = int(xs.shape[-1])
                report["vectors"][name] = {
                    "points": n_pts, "pad": (-n_pts) % chunk}
                print(f"# {name}: {n_pts} pts (+{(-n_pts) % chunk} pad, "
                      f"packed)", file=sys.stderr)
                yield (name, _padded_words(xs, chunk),
                       _padded_words(ys, chunk), n_pts)

        coo = {tag: CooMatrix.from_sparse_rows(rows, m)
               for tag, rows in (("a", sap.a), ("b", sap.b), ("c", sap.c))}
        write_dir(out, data["vk"].tobytes(), (m0, m - m0, n_r), small,
                  big(), coo)
    print(f"# wrote {out}", file=sys.stderr)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
