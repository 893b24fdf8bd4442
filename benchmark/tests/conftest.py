"""CPU tests of the benchmark at tiny sizes: ``python3 -m pytest
benchmark/tests`` from the repository root (a few minutes on one core;
every prove runs the kernels' plain versions)."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "bench": {"circuit": "bench", "num_constraints": 4, "num_variables": 4,
              "transcript": "merlin", "setup_seed": 5, "statement_pool": 0},
    "mimc": {"circuit": "mimc_batch", "instances": 2, "rounds": 3,
             "constants_seed": 7, "transcript": "merlin", "setup_seed": 5,
             "statement_pool": 2},
}
LOOP = {"traffic": "prove_loop", "loop": "closed", "provers": 1,
        "warm_proves": 1}


def tiny_cell(tmp_path, which: str):
    """A cell of a tiny configuration, with the real metric lists."""
    from benchmark.harness import spec
    path = os.path.join(tmp_path, f"tiny_{which}.json")
    with open(path, "w") as f:
        json.dump(TINY[which], f)
    bench = spec.benchmark()
    return spec.Cell(f"tiny_{which}", f"tiny_{which}", path, LOOP,
                     bench["end_to_end"], bench["per_layer"])


@pytest.fixture(scope="session")
def work(tmp_path_factory):
    """One directory for the session's keys and traces, so that each tiny
    key is set up once."""
    return str(tmp_path_factory.mktemp("bench"))
