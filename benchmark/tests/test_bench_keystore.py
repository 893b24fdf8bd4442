"""The key store: a second run loads the key its first run made, and a
changed source byte changes the key's name."""

import os
import shutil

from benchmark.harness import keystore


def test_second_run_loads(tmp_path):
    from polymath_tpu_torch.circuits import BenchCircuit
    from polymath_tpu_torch.protocol import Polymath, Rng
    pm = Polymath(device="cpu")
    made = []

    def make():
        made.append(1)
        return pm.setup(BenchCircuit(num_variables=4, num_constraints=4),
                        Rng(5))[0]

    path = keystore.key_dir("tiny", 5, keystore.source_hash(),
                            str(tmp_path / "keys"))
    pk1, load1, first = keystore.load_or_make(path, make, "cpu")
    pk2, load2, second = keystore.load_or_make(path, make, "cpu")
    assert (first, second, len(made)) == (True, False, 1)
    assert pk1.vk.to_bytes() == pk2.vk.to_bytes()
    assert load1 > 0 and load2 > 0
    assert sorted(os.listdir(tmp_path / "keys")) == [
        os.path.basename(path), os.path.basename(path) + ".lock"]


def test_source_byte_changes_the_name(tmp_path):
    prog = tmp_path / "prog"
    shutil.copytree(os.path.join(keystore.ROOT, keystore.PROGRAM), prog,
                    ignore=shutil.ignore_patterns("__pycache__", "*.so*"))
    before = keystore.source_hash(program_dir=str(prog))
    assert before == keystore.source_hash()
    cu = prog / "csrc" / "scan.cu"
    data = bytearray(cu.read_bytes())
    data[-1] ^= 1
    cu.write_bytes(bytes(data))
    after = keystore.source_hash(program_dir=str(prog))
    assert after != before
    assert (keystore.key_dir("c", 0, before) != keystore.key_dir("c", 0, after))
    # build outputs beside the sources do not count
    (prog / "native" / "libx.so").write_bytes(b"x")
    assert keystore.source_hash(program_dir=str(prog)) == after
