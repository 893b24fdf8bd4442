"""Port G1 layer (polymath_tpu_torch.ops.curve / cuda_curve / cuda_gather)
against the JAX reference's plain formulas (curve_jax.jac_add_core,
jac_madd_core fast and safe) and the host group law, bit for bit, on the
CPU.

The point batch carries every degenerate lane the kernels select on: the
identity on either side, a (0, 0) leaf, P + P (with Z = 1 and Z != 1) and
P + (-P).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polymath_tpu.ops import curve_jax as CJ
from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.ops import curve as C
from polymath_tpu_torch.ops import cuda_curve, cuda_gather
from polymath_tpu_torch.ops.curve import AFF, FW, JAC

N = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_points(n, start=2):
    pts, cur = [], bls.G1.mul(bls.G1.gen, start)
    for _ in range(n):
        pts.append(cur)
        cur = bls.G1.add(cur, bls.G1.gen)
    return pts


@pytest.fixture(scope="module")
def batch():
    """(acc Jacobian (36, N), leaf affine (24, N), q Jacobian (36, N)) words
    and the host points they encode (None = identity)."""
    pts = _host_points(N)
    other = _host_points(N, start=50)
    aff = C.points_to_device(pts)
    leaf = C.points_to_device(other)
    # accumulators with Z != 1: P_i + (P_i + G), formed by the port's add
    acc = cuda_curve.jac_add(C.affine_to_jac_words(aff),
                             C.affine_to_jac_words(
                                 C.points_to_device(_host_points(N, 3))))
    acc_host = [bls.G1.add(p, q) for p, q in zip(pts, _host_points(N, 3))]
    leaf_host = list(other)
    acc[:, 0] = C.jac_identity_words(())                 # identity acc
    acc_host[0] = None
    leaf[:, 1] = 0                                       # (0, 0) leaf
    leaf_host[1] = None
    leaf[:, 2] = C.points_to_device([acc_host[2]])[:, 0]  # P + P, Z != 1
    leaf_host[2] = acc_host[2]
    leaf[:, 3] = C.points_to_device([bls.G1.neg(acc_host[3])])[:, 0]
    leaf_host[3] = bls.G1.neg(acc_host[3])                # P + (-P)
    acc[:, 4] = C.affine_to_jac_words(aff[:, 4:5])[:, 0]  # P + P, Z = 1
    acc_host[4] = pts[4]
    leaf[:, 4] = aff[:, 4]
    leaf_host[4] = pts[4]
    q = C.affine_to_jac_words(leaf)
    q[:, 5] = C.jac_identity_words(())                   # identity q
    q_host = list(leaf_host)
    q_host[5] = None
    q[:, 6] = acc[:, 6]                                  # P + P, both Z != 1
    q_host[6] = acc_host[6]
    return acc, leaf, q, acc_host, leaf_host, q_host


def _jax(words, coords):
    limbs = C.split_words(words, coords)
    return tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in limbs)


def _words(coords):
    return C.join_words(tuple(torch.from_numpy(np.asarray(c).astype(np.int64))
                              for c in coords))


def test_jac_add_matches_reference_and_host(batch):
    acc, _, q, acc_host, _, q_host = batch
    got = cuda_curve.jac_add(acc, q)
    want = _words(CJ.jac_add_core(_jax(acc, 3), _jax(q, 3)))
    assert torch.equal(got, want)
    assert C.jac_to_host(got) == [bls.G1.add(a, b)
                                  for a, b in zip(acc_host, q_host)]


def test_jac_madd_fast_and_safe_match_reference_and_host(batch):
    """Both forms against the reference's jac_madd_core.  The fast form
    equals the safe one everywhere but on the lanes it flags, where the
    skipped doubling leaves the formula's all-zero value (the reference's
    fast output there, and what the kernel writes)."""
    acc, leaf, _, acc_host, leaf_host, _ = batch
    got, err = cuda_curve.jac_madd(acc, leaf)
    assert err is None
    want, _ = CJ.jac_madd_core(_jax(acc, 3), _jax(leaf, 2), False)
    assert torch.equal(got, _words(want))
    assert C.jac_to_host(got) == [bls.G1.add(a, b)
                                  for a, b in zip(acc_host, leaf_host)]
    fast, ferr = cuda_curve.jac_madd(acc, leaf, True)
    want_fast, want_err = CJ.jac_madd_core(_jax(acc, 3), _jax(leaf, 2), True)
    assert torch.equal(fast, _words(want_fast))
    assert ferr.bool().tolist() == np.asarray(want_err).tolist()
    assert ferr.nonzero().flatten().tolist() == [2, 4]
    keep = ferr == 0
    assert torch.equal(fast[:, keep], got[:, keep])
    assert not fast[:, ~keep].any()


def test_out_view_and_identity_helpers(batch):
    acc, leaf, _, _, _, _ = batch
    buf = torch.zeros((JAC, 2, N), dtype=torch.int32)
    out, _ = cuda_curve.jac_madd(acc, leaf, out=buf[:, 1])
    assert torch.equal(out, buf[:, 1])
    assert torch.equal(buf[:, 1], cuda_curve.jac_madd(acc, leaf)[0])
    idn = C.jac_identity_words((3,))
    assert C.jac_to_host(idn) == [None] * 3
    assert torch.equal(C.affine_to_jac_words(torch.zeros((AFF, 2),
                                                         dtype=torch.int32))[2 * FW:],
                       torch.zeros((FW, 2), dtype=torch.int32))


def test_to_affine_and_host_round_trip(batch):
    acc, _, _, acc_host, _, _ = batch
    aff = cuda_curve.to_affine(acc)
    assert C.affine_to_host(aff) == acc_host
    assert C.jac_to_host(acc) == acc_host
    assert torch.equal(C.points_to_device(acc_host), aff)


def test_tree_sum_and_prefix_scan(batch):
    acc, _, q, acc_host, _, q_host = batch
    pj = torch.stack([acc[:, :5], q[:, :5], acc[:, 5:10]], dim=1)  # (36, 3, 5)
    host = [acc_host[:5], q_host[:5], acc_host[5:10]]
    total = C.tree_sum_jac(pj)
    want = [bls.G1.add(bls.G1.add(a, b), c) for a, b, c in zip(*host)]
    assert C.jac_to_host(total) == want
    ps = C.prefix_scan_jac(pj)
    assert C.jac_to_host(ps[:, 1]) == [bls.G1.add(a, b)
                                       for a, b in zip(host[0], host[1])]
    assert C.jac_to_host(ps[:, 2]) == want


def test_gather_rows_plain_contract():
    g = torch.Generator().manual_seed(3)
    table = torch.randint(-2**31, 2**31 - 1, (9, AFF), generator=g,
                          dtype=torch.int32)
    idx = torch.tensor([[0, 8, 9], [4, 9, 1]])
    out = cuda_gather.gather_rows(table, idx)
    assert out.shape == (AFF, 2, 3)
    assert torch.equal(out[:, 0, 1], table[8])
    assert torch.equal(out[:, 1, 2], table[1])
    assert not out[:, 0, 2].any() and not out[:, 1, 1].any()
    with pytest.raises(TypeError):
        cuda_gather.gather_rows(table, idx.to(torch.int32))
    assert cuda_gather.LAUNCHES["gather_rows"] == 0


def test_jac_double_matches_reference_and_host(batch):
    """cuda_curve.jac_double (plain path on the CPU) against the reference's
    curve_jax.jac_double and the host group law.  Identity lanes double to
    Z = 0 with the formula's X and Y: one with X = Y = 1, one whose X and Y
    are those of a finite point."""
    acc, _, q, acc_host, _, _ = batch
    p = torch.cat([acc, q[:, 6:8]], dim=1)
    p[2 * FW:, -1] = 0
    host = acc_host + [acc_host[6], None]
    got = cuda_curve.jac_double(p)
    want = CJ.jac_double(_jax(p, 3))
    assert torch.equal(got, _words(want))
    assert C.jac_to_host(got) == [bls.G1.double(h) if h else None
                                  for h in host]
    assert not got[2 * FW:, 0].any() and not got[2 * FW:, -1].any()
    assert got[:2 * FW, -1].any()
    assert torch.equal(cuda_curve.jac_double(p.reshape(JAC, 2, -1)),
                       got.reshape(JAC, 2, -1))
    assert cuda_curve.LAUNCHES["jac_double"] == 0
