"""The port's measurement entry points (polymath_tpu_torch.tools) on the CPU,
through the kernels' plain versions.

* T1 (pgather_variants): the reference tool's own ``make_call`` with each
  of its six bodies, run in Pallas interpret mode on a seeded table of
  n = 2^14 points (t4 = 4097 >= 4096, for the noidx probe) and m = 2048
  rows, against the port, bit for bit.
* T2 (primbench): the tool's nine bodies (copied from
  tools/primbench.py:58-66, where they are local to its ``main``) through
  a ``pl.pallas_call`` with the tool's BlockSpec at GRID = 2 and the full
  K = 512, block 0 filled with the tool's constant and block 1 random,
  against the port: bit for bit, but for the f32 b * a + a row at rtol
  1e-4 (XLA may fuse it, the port's plain version rounds twice).
* kernel_metrics passes its host-oracle check at 2^8 points; fusedprof's
  stages compose to msm_chunk's window sums, split and fused, at a
  16-point chunk; kernel_table's rows compare equal at tiny shapes;
  msmtime at N = 256 with two configurations gives one point, and raises
  where two differ; every tool raises without a card unless asked for the
  CPU.
"""

import functools
import os
import re
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import tools.pgather_variants as PV
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.tools import fusedprof, kernel_metrics, kernel_table
from polymath_tpu_torch.tools import msmtime, productprobe
from polymath_tpu_torch.tools import pgather_variants as GV
from polymath_tpu_torch.tools import primbench as PB


def _ids(names):
    """Test ids without spaces or brackets: u32 mul (a<2^16 hint?) ->
    u32_mul_a_2_16_hint."""
    return [re.sub(r"\W+", "_", n).strip("_") for n in names]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- T1 -----------------------------------------------------------------------

T1_N, T1_M = 1 << 14, 2048
TOOL_BODIES = {
    "rowload u8": lambda: PV.v_rowload(8),
    "rowload u16": lambda: PV.v_rowload(16),
    "tileload u8": lambda: PV.v_tileload(8),
    "tileload u16": lambda: PV.v_tileload(16),
    "probe noidx u8": lambda: PV.v_noop(8),
    "probe noextract u8": lambda: PV.v_noextract(8),
}


@pytest.fixture(scope="module")
def t1_inputs():
    quad, idx = GV.make_inputs(T1_N, 1, seed=3)
    return quad, idx[:T1_M].contiguous()


@pytest.mark.parametrize("variant", GV.VARIANTS, ids=_ids(GV.VARIANTS))
def test_gather_variant_matches_tool_kernel(variant, t1_inputs):
    quad, idx = t1_inputs
    assert quad.shape == (4097, 128)
    interpret = functools.partial(pl.pallas_call, interpret=True)
    with mock.patch.object(PV.pl, "pallas_call", interpret):
        call = PV.make_call(TOOL_BODIES[variant](), quad.shape[0], T1_M)
        i = jnp.asarray(idx.numpy()).reshape(1, -1)
        q = jnp.asarray(quad.numpy().view(np.uint32))
        want = np.asarray(call(i, i, q))
    got = GV.gather_variant(variant, quad, idx)
    assert got.shape == (PV.ROW, T1_M) and got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_gather_variant_edges_and_checks(t1_inputs):
    quad, idx = t1_inputs
    bad = idx.clone()
    bad[:3] = torch.tensor([-1, 4 * quad.shape[0], 4 * quad.shape[0] - 1])
    got = GV.gather_variant("rowload u8", quad, bad)
    assert not got[:, :2].any()                       # outside: zero rows
    assert torch.equal(got[:, 2], quad[-1, 72:96])    # the last row
    with pytest.raises(ValueError):
        GV.gather_variant("rowload u8", quad, idx[:1000])
    with pytest.raises(ValueError):
        GV.gather_variant("probe noidx u8", quad[:4095].contiguous(), idx)
    with pytest.raises(ValueError):
        GV.gather_variant("rowload u32", quad, idx)
    res = GV.main(["--device", "cpu", "--log-n", "14", "--windows", "1",
                   "--reps", "1"])
    assert [v["name"] for v in res["variants"]] == list(GV.VARIANTS)
    assert res["device"] == "cpu" and res["m"] == T1_N
    assert all(v["mismatches"] == 0 for v in res["variants"])
    assert not any(GV.LAUNCHES.values())              # no kernel on the CPU


# -- T2 -----------------------------------------------------------------------

_M16 = np.uint32(0xFFFF)
#: tools/primbench.py:58-66
TOOL_ROWS = (
    ("u32 add", lambda b, a, i: b + a, jnp.uint32, 3),
    ("u32 mul", lambda b, a, i: b * a, jnp.uint32, 3),
    ("u32 mul (a<2^16 hint?)", lambda b, a, i: (b & _M16) * a, jnp.uint32, 3),
    ("u32 shift+and", lambda b, a, i: (b >> np.uint32(1)) ^ (a & _M16),
     jnp.uint32, 3),
    ("i32 mul", lambda b, a, i: b * a, jnp.int32, 3),
    ("f32 mul", lambda b, a, i: b * a, jnp.float32, 1.0000001),
    ("f32 fma-ish", lambda b, a, i: b * a + a, jnp.float32, 1.0000001),
    ("u16 mul", lambda b, a, i: b * a, jnp.uint16, 3),
    ("u32 select", lambda b, a, i: jnp.where(a > 1, b, a), jnp.uint32, 3),
)


def _tool_chain(body, dtype, x: np.ndarray) -> np.ndarray:
    """The tool's kernel with its BlockSpec, at GRID = x.shape[0] // ROWS."""
    spec = pl.BlockSpec((PB.ROWS, PB.LANES), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)

    def kernel(x_ref, o_ref):
        a = x_ref[...]
        b = a
        for i in range(PB.K):
            b = body(b, a, i)
        o_ref[...] = b

    call = pl.pallas_call(
        kernel, grid=(x.shape[0] // PB.ROWS,), in_specs=[spec],
        out_specs=spec, out_shape=jax.ShapeDtypeStruct(x.shape, dtype),
        interpret=True)
    return np.asarray(call(jnp.asarray(x)))


@pytest.mark.parametrize("row", range(len(TOOL_ROWS)),
                         ids=_ids(r[0] for r in TOOL_ROWS))
def test_primbench_row_matches_tool_body(row):
    name, body, dtype, init = TOOL_ROWS[row]
    spec = PB.ROW_SPECS[row]
    assert (spec.name, spec.init) == (name, init)
    x = torch.cat([PB.make_input(row)[:PB.ROWS],
                   PB.make_input(row, seed=row + 1)[:PB.ROWS]])
    want = _tool_chain(body, dtype, x.numpy().view(np.dtype(dtype)))
    got = PB.chain(name, x).numpy().view(np.dtype(dtype))
    assert got.shape == (2 * PB.ROWS, PB.LANES)
    if name == PB.FUSED_ROW:
        assert np.isfinite(want).all()
        np.testing.assert_allclose(got, want, rtol=PB.F32_RTOL, atol=0)
    else:
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert (got[:PB.ROWS] == got[0, 0]).all()         # the constant block


def test_primbench_checks():
    x = PB.make_input("u32 add")
    want = PB.chain_plain("u32 add", x)
    assert PB.max_error("u32 add", want, want) == 0
    off = want.clone()
    off[3, 5] ^= 1
    with pytest.raises(AssertionError, match="1 elements differ"):
        PB.max_error("u32 add", off, want)
    with pytest.raises(TypeError):
        PB.chain("u16 mul", x)
    b, by = PB.row_bound_ms("u32 add")
    assert by == "operations" and abs(b - 2 ** 26 / 16.7e12 * 1e3) < 1e-9
    assert PB.row_bound_ms("f32 mul")[0] * 2 == pytest.approx(b, rel=0.01)
    assert not any(PB.LAUNCHES.values())              # no kernel on the CPU


@pytest.mark.parametrize("seed", [None, 6])
def test_primbench_f32_mul_rejects_a_short_chain(seed):
    """At the tool's constant 1 + 2^-23 the chain's answer is within 1e-4
    of its input: only a bit-for-bit comparison fails a kernel that returns
    x or stops a step short."""
    x = PB.make_input("f32 mul", seed=seed)
    want = PB.chain_plain("f32 mul", x)
    assert PB.max_error("f32 mul", want.clone(), want) == 0
    if seed is None:
        assert torch.allclose(x, want, rtol=PB.F32_RTOL, atol=0)
    short = x
    for _ in range(PB.K - 1):
        short = short * x
    assert not torch.equal(short, want)
    for wrong in (x, short):
        with pytest.raises(AssertionError, match="elements differ"):
            PB.max_error("f32 mul", wrong, want)


# -- kernel_metrics, fusedprof, the device rule -------------------------------

def test_kernel_metrics_oracle_small():
    res = kernel_metrics.main(["--device", "cpu", "--log-n", "8",
                               "--reps", "1"])
    assert res["msm_oracle_check"].startswith("ok")
    assert set(res["kernels"]) == {"ntt_2^8", "msm_2^8"}
    assert res["kernels"]["msm_2^8"]["points_per_s"] > 0
    assert res["device"] == "cpu"


def test_fusedprof_stages_compose_to_msm_chunk():
    res = fusedprof.main(["--device", "cpu", "--log-chunk", "4",
                          "--reps", "1"])
    assert res["stages_match"]
    assert (res["chunk"], res["seq"], res["rows"]) == (16, 4, 4)
    assert set(fusedprof.SPLIT) | set(fusedprof.FUSED) | {
        "msm_chunk split", "msm_chunk fused"} == set(res["stages_ms"])


def test_productprobe_small():
    """The probe's to_affine lanes at two small counts on the CPU (no SASS
    without nvcc); its own check holds them against the plain version."""
    res = productprobe.main(["--device", "cpu", "--lanes", "16,64",
                             "--reps", "1"])
    assert set(res["to_affine"]) == {"16", "64"}
    assert res["chain"] == 385 + 232 and res["sass"] is None
    assert all(v["ns_per_step"] > 0 for v in res["to_affine"].values())


def test_kernel_table_small(monkeypatch):
    """Every row of the kernel table at a tiny shape on the CPU, where each
    kernel's wrapper runs its plain version: each compares equal."""
    monkeypatch.setattr(kernel_table, "SHAPES", {
        "fr": 1 << 12, "lanes": 1 << 7, "chunk": 1 << 6, "ntt": (2, 2048),
        "ntt_wide": (1, 4096), "quotient": 4103,
        "pgather_variants": ["--log-n", "14", "--windows", "1", "--reps",
                             "1"],
        "primbench": ["--reps", "1"]})
    res = kernel_table.main(["--device", "cpu"])
    assert res["device"] == "cpu"
    rows = res["kernels"]
    assert len(rows) == 21 + len(GV.VARIANTS) + len(PB.NAMES)
    assert {"fr_mul", "fr_sqr", "fr_butterfly", "jac_madd", "jac_add",
            "jac_double", "to_affine", "sum_sets (40 sets)", "gather_rows",
            "fused_scan", "madd_scan", "row_offsets", "window_fold",
            "ntt_local", "ntt_local (wide)", "affine_scan_reduce",
            "affine_scan_apply", "quotient scan"} <= set(rows)
    assert all(r["max_abs_err"] == 0 and r["bound_ms"] > 0
               for r in rows.values() if "max_abs_err" in r)


# -- msmtime, the device rule -------------------------------------------------

def test_msmtime_gives_one_point():
    res = msmtime.main(["--device", "cpu", "--n", "256", "--configs",
                        "256:4;256:6:8", "--reps", "1"])
    assert res["same_point"] and res["device"] == "cpu"
    assert [(r["chunk"], r["c"], r["seq"]) for r in res["configs"]] == \
        [(256, 4, 16), (256, 6, 8)]
    assert "POLYMATH_MSM_C" not in os.environ


def test_msmtime_raises_on_differing_points(monkeypatch):
    monkeypatch.setattr(msmtime, "fixed_base_mul", lambda sc: sc.T)
    monkeypatch.setattr(M, "msm_device",
                        lambda *a, **k: os.environ["POLYMATH_MSM_C"])
    with pytest.raises(AssertionError, match="differs"):
        msmtime.main(["--device", "cpu", "--n", "4", "--configs",
                      "4:4;4:5", "--reps", "1"])


@pytest.mark.parametrize("tool", [PB, GV, kernel_metrics, fusedprof,
                                  productprobe, kernel_table],
                         ids=["primbench", "pgather_variants",
                              "kernel_metrics", "fusedprof", "productprobe",
                              "kernel_table"])
def test_tools_need_a_card_or_an_explicit_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tool.main([])
