"""The frozen reference: its verifying key from the setup seed equals the
port's CPU setup's, it verifies the port's proofs and rejects altered
ones, and nothing in benchmark/ imports JAX or the JAX package (the
reference imports nothing of the program either)."""

import ast
import os
import random

import pytest

from benchmark.circuits import bench as bench_kind, mimc_batch
from benchmark.ref import verify
from benchmark.ref.kinds import bench as ref_bench, mimc_batch as ref_mimc

from conftest import TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "polymath_tpu"}


@pytest.mark.parametrize("which", ["bench", "mimc"])
def test_vk_and_proof_against_cpu_setup(which):
    from polymath_tpu_torch.protocol import Polymath, Rng
    cfg = TINY[which]
    kind, ref = ((bench_kind, ref_bench) if which == "bench"
                 else (mimc_batch, ref_mimc))
    pm = Polymath(device="cpu")
    pk, vk = pm.setup(kind.setup_circuit(cfg), Rng(cfg["setup_seed"]))
    ref_vk = verify.derive_vk(cfg["setup_seed"], *ref.shape(cfg))
    assert ref_vk.to_bytes() == vk.to_bytes()

    st = kind.draw_statement(cfg, random.Random(3))
    proof = pm.prove(pk, kind.prove_circuit(cfg, kind.prepare(cfg, st)),
                     Rng(4)).to_bytes()
    statement = verify.Statement(ref.publics(cfg, st))
    assert verify.verify_batch(ref_vk, [(statement, proof)] * 2, 1) == []
    bad = bytearray(proof)
    bad[100] ^= 1                                      # a_at_x1
    other = verify.Statement([v + 1 for v in ref.publics(cfg, st)])
    assert verify.verify_batch(
        ref_vk, [(statement, proof), (statement, bytes(bad)),
                 (other, proof), (statement, proof[:-1])], 1) == [1, 2, 3]


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def _sources(top: str):
    for d, dirs, files in os.walk(top):
        dirs[:] = [x for x in dirs if not x.startswith(".")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_anywhere_and_no_program_in_the_reference():
    seen = 0
    for path in _sources(HERE):
        names = _imports(path)
        assert not names & FORBIDDEN, (path, names & FORBIDDEN)
        if os.sep + "ref" + os.sep in path:
            assert "polymath_tpu_torch" not in names, path
            assert names <= {"random", "__future__"}, (path, names)
        seen += 1
    assert seen > 20
