"""The port's slice as a whole, on the CPU through the kernels' plain
versions, held byte for byte against the JAX package:

* sparse matvecs against frontend.sap.sparse_matvec (a row and a column
  of more than 2^15 entries, and a key's two-level segment plan);
* synthetic division against poly_host.synthetic_divide;
* the port's setup and prove for DummyCircuit / Rng(1234) against
  tests/fixtures/golden_dummy.json, for all three transcripts;
* a reduced MiMC key written by the JAX package's save_dir, loaded by the
  port's load_dir: the port's proof equals the JAX host prover's;
* PI(x1) against the JAX package's at the benchmark's MiMC domain, zero
  denominators included, and a proof over a batch of MiMC preimages
  (more than two public inputs) through the port's verifier;
* the corrupt-witness case, a key without a device SRS, and the
  package's hygiene (no jax or polymath_tpu import; no silent CPU
  fallback).
"""

import ast
import copy
import json
import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from polymath_tpu.frontend.r1cs import (
    ConstraintSystem as RefCS, synthesize as ref_synthesize,
)
from polymath_tpu.frontend.sap import sparse_matvec
from polymath_tpu.native import g1_msm as ref_g1_msm
from polymath_tpu.ops.sparse import plan_segments, MAX_SEG
from polymath_tpu.protocol import Polymath as RefPolymath, Rng as RefRng
from polymath_tpu.protocol import common as ref_common
from polymath_tpu.protocol.data_structures import (
    Proof as RefProof, VerifyingKey as RefVK,
)
from polymath_tpu.protocol.poly_host import synthetic_divide
from polymath_tpu.protocol.prover import (
    create_proof_with_assignment as ref_create_proof,
)
from polymath_tpu.circuits.mimc import MiMCDemo as RefMiMC, mimc_hash
from polymath_tpu.transcript import MerlinFieldTranscript as RefMerlin

from polymath_tpu_torch.circuits import DummyCircuit, MiMCDemo
from polymath_tpu_torch.frontend.r1cs import lc
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_limbs, words_to_ints
from polymath_tpu_torch.ops.poly import synthetic_divide_device
from polymath_tpu_torch.ops.prover import fr_ints_to_mont_device
from polymath_tpu_torch.ops.sparse import CooMatrix, coo_matvec
from polymath_tpu_torch.protocol import Polymath, Rng, common, keys
from polymath_tpu_torch.protocol.poly_host import Radix2Domain, batch_inverse
from polymath_tpu_torch.transcript import (
    ALL_TRANSCRIPTS, MerlinFieldTranscript,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")
with open(os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_dummy.json")) as _fh:
    GOLDEN = json.load(_fh)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canon(words):
    return [FR_SPEC.from_mont_int(v) for v in words_to_ints(words.numpy())]


@pytest.mark.parametrize("dense", ["row", "column"])
def test_coo_matvec_matches_sparse_matvec(dense):
    """A row of more than 2^15 entries (one segment past the reference's
    one-level limit) or a column read by more than 2^15 rows."""
    rng = random.Random(3)
    num_cols = 40
    rows = [[(rng.randrange(R), rng.randrange(num_cols))
             for _ in range(rng.randrange(0, 4))] for _ in range(12)]
    if dense == "row":
        rows.insert(5, [(1 + (j % 3), j % num_cols)
                        for j in range(MAX_SEG + 70)])
    else:
        rows += [[(rng.randrange(R), 7)] for _ in range(MAX_SEG + 70)]
    z = [rng.randrange(R) for _ in range(num_cols)]
    want = sparse_matvec(rows, z)
    zm = fr_ints_to_mont_device(z, CPU)
    mat = CooMatrix.from_sparse_rows(rows, num_cols)
    assert _canon(coo_matvec(mat, zm)) == want
    # the same matrix as a reference key stores it: sub-segment ids of
    # its segment plan (two-level for the dense row) plus the optional
    # sub-segment -> row map
    row_ids = np.asarray(mat.row_idx)
    sub_ids, lvl2, _ = plan_segments(row_ids.astype(np.int32), len(rows))
    assert (lvl2 is not None) == (dense == "row")
    coeff_limbs = ints_to_limbs(words_to_ints(mat.coeffs_mont.numpy()), 16)
    mat2 = CooMatrix.from_arrays(sub_ids, np.asarray(mat.col_idx),
                                 coeff_limbs, lvl2, len(rows), num_cols)
    assert _canon(coo_matvec(mat2, zm)) == want


@pytest.mark.parametrize("length", [64, 65, 150, 4097])
def test_synthetic_divide_matches_host(length):
    rng = random.Random(length)
    coeffs = [rng.randrange(R) for _ in range(length)]
    x1 = rng.randrange(R)
    q_want, r_want = synthetic_divide(coeffs, x1)
    q, r = synthetic_divide_device(fr_ints_to_mont_device(coeffs, CPU),
                                   fr_ints_to_mont_device([x1], CPU))
    assert _canon(r) == [r_want]
    assert _canon(q) == q_want


@pytest.fixture(scope="module")
def dummy_key():
    """The port's setup of DummyCircuit with Rng(1234), on the CPU, and
    the Rng state right after it."""
    rng = Rng(1234)
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    pk, vk = pm.setup(DummyCircuit(), rng)
    return pk, vk, rng


@pytest.mark.parametrize("transcript", ALL_TRANSCRIPTS, ids=lambda t: t.name)
def test_golden_dummy_bytes(dummy_key, transcript):
    pk, vk, rng_after_setup = dummy_key
    golden = GOLDEN[transcript.name]
    assert vk.to_bytes().hex() == golden["vk"]
    pm = Polymath(transcript=transcript, device="cpu")
    proof = pm.prove(pk, DummyCircuit(5, 7),
                     copy.deepcopy(rng_after_setup))
    assert proof.to_bytes().hex() == golden["proof"]
    assert pm.verify(vk, [35], proof)
    assert not pm.verify(vk, [36], proof)


class UnsatisfiableCircuit:
    """a*b = c with the input assigned a*b + 1: synthesizes, but the
    witness violates the constraint."""

    def __init__(self, a=None, b=None):
        self.a = a
        self.b = b

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(
            lambda: None if (self.a is None or self.b is None)
            else (self.a * self.b + 1) % R)
        cs.enforce_constraint(lc(a), lc(b), lc(c))


def test_corrupt_witness_raises(dummy_key):
    pk, _, _ = dummy_key
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    with pytest.raises(AssertionError, match="vanishing division"):
        pm.prove(pk, UnsatisfiableCircuit(5, 7), Rng(3))


def test_key_without_device_srs_is_refused(dummy_key):
    """The prover takes keys from Polymath.setup or keys.load_dir, whose
    SRS lies on the device; a key in host form is refused, not converted."""
    pk = copy.copy(dummy_key[0])
    pk.device = {}
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    with pytest.raises(ValueError, match="no device SRS"):
        pm.prove(pk, DummyCircuit(5, 7), Rng(3))


def test_jax_saved_mimc_key_gives_the_host_proof(tmp_path):
    """Reduced MiMC (5 rounds): a key made by the JAX package's host
    backend and written by its save_dir, loaded by the port's load_dir,
    proves to the bytes of the JAX package's host prover with the same Rng
    state.  The host prover runs with the package's native G1 MSM in its
    MSM hook (an exact group sum, as its default Pippenger, only faster);
    the native wrapper reads len(points) pairs, so the points are cut to
    the scalars as the default's zip does."""
    rounds = 5
    crng = random.Random(9)
    consts = [crng.randrange(R) for _ in range(rounds)]
    rng = RefRng(7)
    xl, xr = rng.randrange(R), rng.randrange(R)
    image = mimc_hash(xl, xr, consts)
    ref = RefPolymath(transcript=RefMerlin, backend="host")
    ref_pk, _ = ref.setup(RefMiMC(constants=consts), rng)
    ref_pk.save_dir(str(tmp_path))
    port_rng = copy.deepcopy(rng)
    cs = ref_synthesize(RefMiMC(xl, xr, consts), RefCS.PROVE)
    want = ref_create_proof(ref_pk, cs.instance_assignment,
                            cs.witness_assignment, rng, RefMerlin,
                            msm=lambda sc, pts: ref_g1_msm(pts[:len(sc)],
                                                           sc))

    pk = keys.load_dir(str(tmp_path), "cpu")
    assert pk.vk.to_bytes() == ref_pk.vk.to_bytes()
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    got = pm.prove(pk, MiMCDemo(xl, xr, consts), port_rng)
    assert got.to_bytes() == want.to_bytes()
    assert pm.verify(pk.vk, [image], got)


#: the benchmark's MiMC batch: 2,096,252 SAP rows, n = 2^21
MIMC_DOMAIN = Radix2Domain(2_096_252)


@pytest.mark.parametrize("x1_at", ["random", "0", "m0-1", "2m0-1"])
@pytest.mark.parametrize("m0", [1, 2, 17, 1626])
def test_pi_at_x1_matches_the_jax_package(m0, x1_at):
    """The batched inversion gives the JAX package's Lagrange sum; where
    x1 is one of the first 2*m0 points of the domain, one denominator is
    0 and both drop its term."""
    assert MIMC_DOMAIN.n == 1 << 21
    vk = SimpleNamespace(n=MIMC_DOMAIN.n, omega=MIMC_DOMAIN.omega)
    rng = random.Random(m0)
    public = [1] + [rng.randrange(R) for _ in range(m0 - 1)]
    y1_gamma = rng.randrange(R)
    if x1_at == "random":
        x1 = rng.randrange(R)
    else:
        i = {"0": 0, "m0-1": m0 - 1, "2m0-1": 2 * m0 - 1}[x1_at]
        x1 = pow(MIMC_DOMAIN.omega, i, R)
    want = ref_common.compute_pi_at_x1(vk, public, x1, y1_gamma)
    assert common.compute_pi_at_x1(vk, public, x1, y1_gamma) == want


@pytest.mark.parametrize("zeros", [(), (0,), (4,), (8,), (0, 4, 8)])
def test_batch_inverse_gives_each_value_its_fermat_power(zeros):
    """One inversion for the batch, a zero left out of the product and
    given 0, as pow(0, r - 2, r) is."""
    rng = random.Random(len(zeros))
    values = [0 if i in zeros else rng.randrange(1, R) for i in range(9)]
    assert batch_inverse(values) == [pow(v, R - 2, R) for v in values]


class MiMCInstances:
    """MiMCDemo composed once a preimage (xl, xr): one public image an
    instance beside the constant 1."""

    def __init__(self, constants, preimages=None, instances=None):
        self.constants = constants
        self.preimages = preimages or [(None, None)] * instances

    def generate_constraints(self, cs):
        for xl, xr in self.preimages:
            MiMCDemo(xl, xr, self.constants).generate_constraints(cs)


def test_mimc_batch_proof_verifies_with_its_images():
    """Five 5-round MiMC preimages in one circuit (m0 = 6, 112 SAP rows):
    the port's proof verifies under the port's verifier and under the JAX
    package's with the five images, and under neither with one image
    changed."""
    crng = random.Random(11)
    consts = [crng.randrange(R) for _ in range(5)]
    preimages = [(crng.randrange(R), crng.randrange(R)) for _ in range(5)]
    images = [mimc_hash(xl, xr, consts) for xl, xr in preimages]
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    rng = Rng(5)
    pk, vk = pm.setup(MiMCInstances(consts, instances=5), rng)
    proof = pm.prove(pk, MiMCInstances(consts, preimages), rng)
    ref = RefPolymath(transcript=RefMerlin, backend="host")
    ref_vk = RefVK.from_bytes(vk.to_bytes())
    ref_proof = RefProof.from_bytes(proof.to_bytes())
    assert pm.verify(vk, images, proof)
    assert ref.verify(ref_vk, images, ref_proof)
    for k in (0, 3):
        bad = list(images)
        bad[k] = (bad[k] + 1) % R
        assert not pm.verify(vk, bad, proof)
        assert not ref.verify(ref_vk, bad, ref_proof)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    """chip_smoke.py and every Python file of the port's package."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "polymath_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return files


def test_import_scan_reads_the_rust_vector_importer():
    files = {os.path.relpath(f, ROOT) for f in _port_files()}
    assert os.path.join("polymath_tpu_torch", "tools",
                        "import_rust_vectors.py") in files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 30
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "polymath_tpu")]
    assert not bad, bad


def test_entry_point_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Polymath(transcript=MerlinFieldTranscript)
    with pytest.raises(RuntimeError):
        Polymath(transcript=MerlinFieldTranscript, device="cuda")
    assert Polymath(transcript=MerlinFieldTranscript,
                    device="cpu").device.type == "cpu"
