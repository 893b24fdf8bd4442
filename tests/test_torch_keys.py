"""The port's proving-key store (polymath_tpu_torch.protocol.keys and
tools/pkconvert.py) against the JAX package's, on the CPU:

* ``plan_segments`` and the COO arrays a dir holds, against the
  reference's planner and ``CooMatrix`` on a row of more than 2^15
  entries (its two-level plan) and on sparse rows;
* a reduced MiMC key (5 rounds), made by the reference's host setup and by
  the port's setup from the same Rng state: the reference's ``save_dir``
  writes dir A and the port's ``keys.save_dir`` dir B, which must match
  file for file (arrays in dtype, shape and value; meta.json as JSON;
  vk.bin bytes);
* the reference's ``load_dir`` reads B as A; the port's load_dir -> save_dir
  turns A into A; the port's load_dir(B) proves to the bytes of the
  reference's host prover;
* version-1 and padded dirs load (their true lengths kept), other versions
  are refused;
* the npz form both ways, and both packages' pkconvert on one npz (at
  ``POLYMATH_MSM_CHUNK=64``) write the same dir.
"""

import copy
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from polymath_tpu.circuits.mimc import MiMCDemo as RefMiMC
from polymath_tpu.frontend.r1cs import (
    ConstraintSystem as RefCS, synthesize as ref_synthesize,
)
from polymath_tpu.native import g1_msm as ref_g1_msm
from polymath_tpu.ops.sparse import (
    CooMatrix as RefCoo, plan_segments as ref_plan_segments,
)
from polymath_tpu.protocol import (
    Polymath as RefPolymath, ProvingKey as RefPK, Rng as RefRng,
)
from polymath_tpu.protocol.prover import (
    create_proof_with_assignment as ref_create_proof,
)
from polymath_tpu.transcript import MerlinFieldTranscript as RefMerlin
import tools.pkconvert as ref_pkconvert

from polymath_tpu_torch.circuits import MiMCDemo
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.ops.sparse import (
    MAX_SEG, CooMatrix, plan_segments,
)
from polymath_tpu_torch.protocol import Polymath, Rng, keys
from polymath_tpu_torch.protocol.data_structures import _PK_BIG
from polymath_tpu_torch.tools import pkconvert
from polymath_tpu_torch.transcript import MerlinFieldTranscript

ROUNDS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_dir(a, b):
    """Dirs a and b hold the same files: .npy arrays equal in dtype, shape
    and value, meta.json equal as JSON, other files byte-equal."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if name.endswith(".npy"):
            xa, xb = np.load(pa), np.load(pb)
            assert (xa.dtype, xa.shape) == (xb.dtype, xb.shape), name
            assert np.array_equal(xa, xb), name
        elif name == "meta.json":
            with open(pa) as fa, open(pb) as fb:
                assert json.load(fa) == json.load(fb)
        else:
            with open(pa, "rb") as fa, open(pb, "rb") as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture(scope="module")
def mimc():
    """Reduced MiMC constants, and the Rng(7) state after drawing the
    preimage (xl, xr) that setup starts from."""
    crng = random.Random(9)
    consts = [crng.randrange(R) for _ in range(ROUNDS)]
    rng = RefRng(7)
    xl, xr = rng.randrange(R), rng.randrange(R)
    return consts, xl, xr


@pytest.fixture(scope="module")
def ref_key(mimc):
    """The reference's host setup: (key, Rng state after setup)."""
    consts, _, _ = mimc
    rng = RefRng(7)
    rng.randrange(R), rng.randrange(R)
    ref = RefPolymath(transcript=RefMerlin, backend="host")
    pk, _ = ref.setup(RefMiMC(constants=consts), rng)
    return pk, rng


@pytest.fixture(scope="module")
def port_key(mimc):
    """The port's setup on the CPU from the same Rng state."""
    consts, _, _ = mimc
    rng = Rng(7)
    rng.randrange(R), rng.randrange(R)
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    return pm.setup(MiMCDemo(constants=consts), rng)[0]


@pytest.fixture(scope="module")
def dir_a(ref_key, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keys") / "A")
    ref_key[0].save_dir(path)
    return path


@pytest.fixture(scope="module")
def dir_b(port_key, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("keys") / "B")
    keys.save_dir(port_key, path)
    return path


def _dense_rows(seed):
    """Twelve sparse rows and one of MAX_SEG + 70 entries (row 5)."""
    rng = random.Random(seed)
    rows = [[(rng.randrange(R), rng.randrange(40))
             for _ in range(rng.randrange(0, 4))] for _ in range(12)]
    rows.insert(5, [(1 + (j % 3), j % 40) for j in range(MAX_SEG + 70)])
    return rows


@pytest.mark.parametrize("dense", [False, True])
def test_plan_segments_matches_the_reference(dense):
    rng = np.random.default_rng(4)
    seg = rng.integers(0, 50, 3000)
    if dense:
        seg = np.concatenate([seg, np.full(2 * MAX_SEG + 5, 7),
                              np.full(MAX_SEG - 1, 8)])
        rng.shuffle(seg)
    got, want = plan_segments(seg, 60), ref_plan_segments(seg, 60)
    assert (got[1] is None) == (want[1] is None) == (not dense)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


def test_coo_arrays_match_the_reference_matrix():
    """What save_dir writes for a matrix with a row past the reference's
    one-level limit is the reference's planned CooMatrix, and it loads
    back to the same matrix."""
    rows = _dense_rows(3)
    mat = CooMatrix.from_sparse_rows(rows, 40)
    ref = RefCoo.from_sparse_rows(rows, 40)
    arrays, meta = keys.coo_arrays(mat)
    assert meta == {"n_sub": ref.n_sub, "num_rows": ref.num_rows,
                    "num_cols": ref.num_cols, "lvl2": True}
    for kind, want in (("row", ref.row_idx), ("col", ref.col_idx),
                       ("coeff", ref.coeffs_mont), ("lvl2", ref.lvl2_idx)):
        want = np.asarray(want)
        assert arrays[kind].dtype == want.dtype, kind
        assert np.array_equal(arrays[kind], want), kind
    back = CooMatrix.from_arrays(arrays["row"], arrays["col"],
                                 arrays["coeff"], arrays["lvl2"],
                                 meta["num_rows"], meta["num_cols"])
    assert torch.equal(back.row_idx, mat.row_idx)
    assert torch.equal(back.coeffs_mont, mat.coeffs_mont)


def test_port_dir_equals_reference_dir(dir_a, dir_b):
    assert_same_dir(dir_a, dir_b)


def test_reference_load_dir_reads_the_port_dir(dir_a, dir_b):
    got = RefPK.load_dir(dir_b)
    with open(os.path.join(dir_a, "vk.bin"), "rb") as fh:
        assert got.vk.to_bytes() == fh.read()
    for name in _PK_BIG:
        for axis, suffix in enumerate(("_x", "_y")):
            want = np.load(os.path.join(dir_a, name + suffix + ".npy"))
            assert np.array_equal(np.asarray(got.device["srs"][name][axis]),
                                  want)
    for tag in "abc":
        want = np.load(os.path.join(dir_a, f"coo_{tag}_coeff.npy"))
        assert np.array_equal(np.asarray(got.device["coo"][tag].coeffs_mont),
                              want)


def test_load_then_save_gives_the_same_dir(dir_a, tmp_path):
    keys.save_dir(keys.load_dir(dir_a, "cpu"), str(tmp_path / "C"))
    assert_same_dir(dir_a, str(tmp_path / "C"))


def test_port_dir_proves_to_the_host_proof(mimc, ref_key, dir_b):
    """The port's key, written by the port and read back, proves to the
    bytes of the reference's host prover (with the reference's key and the
    same Rng state; the native MSM in its hook, cut to the scalars as in
    tests/test_torch_prover.py)."""
    consts, xl, xr = mimc
    ref_pk, rng = ref_key
    cs = ref_synthesize(RefMiMC(xl, xr, consts), RefCS.PROVE)
    want = ref_create_proof(ref_pk, cs.instance_assignment,
                            cs.witness_assignment, copy.deepcopy(rng),
                            RefMerlin,
                            msm=lambda sc, pts: ref_g1_msm(pts[:len(sc)],
                                                           sc))
    pk = keys.load_dir(dir_b, "cpu")
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    got = pm.prove(pk, MiMCDemo(xl, xr, consts), copy.deepcopy(rng))
    assert got.to_bytes() == want.to_bytes()


def _rewrite(src, dst, meta_edit, array_edit):
    """Copy dir src to dst, passing each big vector's arrays through
    array_edit and meta.json through meta_edit."""
    os.makedirs(dst)
    for name in os.listdir(src):
        if name == "meta.json":
            continue
        p = os.path.join(src, name)
        if name.endswith(".npy"):
            arr = np.load(p)
            if name.rsplit("_", 1)[0] in _PK_BIG:
                arr = array_edit(arr)
            np.save(os.path.join(dst, name), arr)
        else:
            shutil.copyfile(p, os.path.join(dst, name))
    with open(os.path.join(src, "meta.json")) as fh:
        meta = meta_edit(json.load(fh))
    with open(os.path.join(dst, "meta.json"), "w") as fh:
        json.dump(meta, fh)


def test_load_dir_reads_v1_and_padded_dirs(dir_a, tmp_path):
    """A version-1 dir ((24, N) 16-bit limbs, not packed) loads to the
    same rows; a dir padded with (0, 0) rows to whole 64-point chunks
    loads with its padding and its true lengths, and is written back as it
    was read."""
    want = keys.load_dir(dir_a, "cpu").device["srs"]

    def v1(meta):
        meta.update(version=1, packed=False)
        return meta

    def unpack(arr):
        out = np.empty((2 * arr.shape[0], arr.shape[1]), np.uint32)
        out[0::2], out[1::2] = arr & 0xFFFF, arr >> 16
        return out

    _rewrite(dir_a, str(tmp_path / "v1"), v1, unpack)
    got = keys.load_dir(str(tmp_path / "v1"), "cpu").device["srs"]
    assert all(torch.equal(got[k], want[k]) for k in _PK_BIG)

    def pad(arr):
        return np.concatenate([arr, np.zeros(
            (arr.shape[0], -arr.shape[1] % 64), arr.dtype)], axis=1)

    _rewrite(dir_a, str(tmp_path / "pad"), lambda m: m, pad)
    pk = keys.load_dir(str(tmp_path / "pad"), "cpu")
    with open(os.path.join(dir_a, "meta.json")) as fh:
        assert pk.device["true_len"] == json.load(fh)["true_len"]
    for k in _PK_BIG:
        rows, n = pk.device["srs"][k], want[k].shape[0]
        assert rows.shape[0] % 64 == 0 and rows.shape[0] > n
        assert torch.equal(rows[:n], want[k]) and not rows[n:].any()
    keys.save_dir(pk, str(tmp_path / "pad2"))
    assert_same_dir(str(tmp_path / "pad"), str(tmp_path / "pad2"))


@pytest.mark.parametrize("version", [3, None])
def test_load_dir_refuses_an_unknown_version(dir_a, tmp_path, version):
    def edit(meta):
        meta["version"] = version
        return meta

    _rewrite(dir_a, str(tmp_path / "v"), edit, lambda a: a)
    with pytest.raises(ValueError, match="version"):
        keys.load_dir(str(tmp_path / "v"), "cpu")


def test_npz_interoperates(ref_key, port_key, tmp_path):
    """The reference's npz loads in the port and the port's in the
    reference, to the same vk and SRS arrays; the two files hold the same
    arrays."""
    ref_pk = ref_key[0]
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_pk.save_npz(ref_path)
    keys.save_npz(port_key, port_path)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f]), f
    got = keys.load_npz(ref_path, "cpu")
    assert got.vk.to_bytes() == port_key.vk.to_bytes()
    assert got.x_powers_y_alpha_g1 == port_key.x_powers_y_alpha_g1
    for k in _PK_BIG:
        assert torch.equal(got.device["srs"][k], port_key.device["srs"][k])
    back = RefPK.load_npz(port_path)
    assert back.vk.to_bytes() == ref_pk.vk.to_bytes()
    with np.load(ref_path) as a:
        for k in _PK_BIG:
            for axis, suffix in enumerate(("_x", "_y")):
                assert np.array_equal(np.asarray(back.device["srs"][k][axis]),
                                      a[k + suffix])


def test_pkconvert_matches_the_reference(ref_key, tmp_path, monkeypatch):
    """Both converters on one npz at 64-point chunks write the same padded
    dir, and the port reads it back to the key's rows."""
    monkeypatch.setenv("POLYMATH_MSM_CHUNK", "64")
    npz = str(tmp_path / "pk.npz")
    ref_key[0].save_npz(npz)
    ref_pkconvert.main(npz, str(tmp_path / "ref.dir"))
    res = pkconvert.main([npz, str(tmp_path / "port.dir")])
    assert res["chunk"] == 64
    assert_same_dir(str(tmp_path / "ref.dir"), str(tmp_path / "port.dir"))
    pk = keys.load_dir(str(tmp_path / "port.dir"), "cpu")
    want = keys.load_npz(npz, "cpu")
    for k in _PK_BIG:
        n = res["vectors"][k]["points"]
        assert pk.device["true_len"][k] == n
        assert torch.equal(pk.device["srs"][k][:n], want.device["srs"][k])
