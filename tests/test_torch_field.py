"""Port field layer (polymath_tpu_torch.ops.field / cuda_field) against the
JAX reference (polymath_tpu.ops.field_jax) and Python ints, bit for bit,
on the CPU.

Inputs are made with numpy from a fixed seed, include the edge values
0, 1, p-1 and p-2, and go to both sides as 16-bit limb arrays; every
comparison is exact (the field ops return canonical values).  The JAX
side runs eagerly at one shape per field, so its per-shape compiles stay
few.
"""

import os
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polymath_tpu.ops import field_jax as RJ
from polymath_tpu_torch.ops import field as F
from polymath_tpu_torch.ops import cuda_field
from polymath_tpu_torch.ops.limbs import (
    FR_SPEC, FQ_SPEC, ints_to_limbs, limbs_to_ints, limbs_to_words,
    words_to_limbs, ints_to_words, words_to_ints,
)

SPECS = {"fr": (FR_SPEC, RJ.FR, F.FR), "fq": (FQ_SPEC, RJ.FQ, F.FQ)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _values(spec, n, seed):
    rng = np.random.default_rng(seed)
    p = spec.modulus
    nb = (p.bit_length() + 7) // 8 + 8
    vals = [int.from_bytes(rng.bytes(nb), "little") % p for _ in range(n)]
    return vals + [0, 1, p - 1, p - 2]


def _mont(spec, vals):
    return ints_to_limbs([spec.to_mont_int(v) for v in vals], spec.L)


def _ref(x):
    return np.asarray(x).astype(np.int64)


def _port(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _ints(spec, t):
    return [spec.from_mont_int(v) for v in limbs_to_ints(t.numpy())]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_ring_ops_match_reference(field):
    spec, ref, port = SPECS[field]
    a = _mont(spec, _values(spec, 28, 1))
    b = _mont(spec, _values(spec, 28, 2)[::-1])
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = _port(a), _port(b)
    for name, want, got in [
        ("add", ref.add(ja, jb), port.add(ta, tb)),
        ("sub", ref.sub(ja, jb), port.sub(ta, tb)),
        ("sub_rev", ref.sub(jb, ja), port.sub(tb, ta)),
        ("neg", ref.neg(ja), port.neg(ta)),
        ("mont_mul", ref.mont_mul(ja, jb), port.mont_mul(ta, tb)),
        ("mont_sqr", ref.mont_sqr(ja), port.mont_sqr(ta)),
        ("to_mont", ref.to_mont(ja), port.to_mont(ta)),
        ("from_mont", ref.from_mont(ja), port.from_mont(ta)),
    ]:
        np.testing.assert_array_equal(_ref(want), got.numpy(), err_msg=name)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_broadcast_mul_and_sqr_is_mul(field):
    spec, _, port = SPECS[field]
    a = _port(_mont(spec, _values(spec, 20, 3)))
    s = a[:, 5:6]
    np.testing.assert_array_equal(port.mont_mul(a, s).numpy(),
                                  port.mont_mul(a, s.expand_as(a)).numpy())
    np.testing.assert_array_equal(port.mont_sqr(a).numpy(),
                                  port.mont_mul(a, a).numpy())
    p = spec.modulus
    vals = _ints(spec, a)
    assert _ints(spec, port.mont_mul(a, s)) == [v * vals[5] % p
                                                for v in vals]


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_carry_redc_sum_reduce(field):
    spec, ref, port = SPECS[field]
    L = spec.L
    rng = np.random.default_rng(4)
    # redundant limbs < 2^20 with a zero top limb: the carry's contract
    t = rng.integers(0, 1 << 20, size=(L + 2, 32), dtype=np.int64)
    t[-1] = 0
    np.testing.assert_array_equal(
        _ref(ref.carry(jnp.asarray(t.astype(np.uint32)))),
        port.carry(_port(t)).numpy())
    # wide canonical values < R * p
    vals = [v * w for v, w in zip(_values(spec, 28, 5),
                                  _values(spec, 28, 6))]
    wide = ints_to_limbs(vals, 2 * L)
    np.testing.assert_array_equal(
        _ref(ref.redc_wide(jnp.asarray(wide))),
        port.redc_wide(_port(wide)).numpy())
    x = _mont(spec, _values(spec, 252, 7)).reshape(L, 8, 32)
    np.testing.assert_array_equal(
        _ref(ref.sum_reduce(jnp.asarray(x), axis=2)),
        port.sum_reduce(_port(x), axis=2).numpy())


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inverse_matches_fermat(field):
    spec, _, port = SPECS[field]
    vals = _values(spec, 4, 8)
    got = port.inv(_port(_mont(spec, vals)))
    p = spec.modulus
    assert _ints(spec, got) == [pow(v, p - 2, p) for v in vals]


@pytest.mark.parametrize("c", [4, 8, 13, 14])
def test_window_digits(c):
    vals = _values(FR_SPEC, 50, 9)
    limbs = ints_to_limbs(vals, 16)
    windows = (255 + c - 1) // c
    want = np.array([[(v >> (w * c)) & ((1 << c) - 1) for v in vals]
                     for w in range(windows)])
    if c == 13:
        np.testing.assert_array_equal(
            want, np.asarray(RJ.FR.window_digits(jnp.asarray(limbs), c,
                                                 windows)))
    np.testing.assert_array_equal(
        want, F.FR.window_digits(_port(limbs), c, windows).numpy())
    words = torch.from_numpy(ints_to_words(vals, 16))
    np.testing.assert_array_equal(
        want, F.fr_window_digits(words, c, windows).numpy())


def test_word_limb_round_trip():
    vals = _values(FQ_SPEC, 10, 10)
    w = torch.from_numpy(ints_to_words(vals, 24))
    limbs = words_to_limbs(w)
    assert limbs_to_ints(limbs.numpy()) == vals
    assert torch.equal(limbs_to_words(limbs), w)
    assert words_to_ints(w.numpy()) == vals


def test_word_ops_and_wrappers_on_cpu():
    """fr_mul / fr_sqr take their plain path only because the tensors lie
    on the CPU; the word-level helpers agree with Python ints."""
    p = FR_SPEC.modulus
    va, vb = _values(FR_SPEC, 60, 11), _values(FR_SPEC, 60, 12)
    wa = torch.from_numpy(ints_to_words([FR_SPEC.to_mont_int(v)
                                         for v in va], 16))
    wb = torch.from_numpy(ints_to_words([FR_SPEC.to_mont_int(v)
                                         for v in vb], 16))

    def ints(w):
        return [FR_SPEC.from_mont_int(v) for v in words_to_ints(w.numpy())]

    assert ints(cuda_field.fr_mul(wa, wb)) == [x * y % p
                                               for x, y in zip(va, vb)]
    assert ints(cuda_field.fr_mul(wa, wb[:, 3:4])) == [x * vb[3] % p
                                                       for x in va]
    assert torch.equal(cuda_field.fr_sqr(wa), cuda_field.fr_mul(wa, wa))
    assert ints(F.fr_add(wa, wb)) == [(x + y) % p for x, y in zip(va, vb)]
    assert ints(F.fr_sub(wa, wb)) == [(x - y) % p for x, y in zip(va, vb)]
    assert ints(F.fr_neg(wa)) == [-x % p for x in va]
    assert words_to_ints(F.fr_from_mont(wa).numpy()) == va
    assert torch.equal(F.fr_to_mont(F.fr_from_mont(wa)), wa)
    assert ints(F.fr_sum(wa, axis=1)) == [sum(va) % p]
    assert ints(F.fr_inv(wa[:, :6])) == [pow(x, p - 2, p) for x in va[:6]]
    assert cuda_field.LAUNCHES["fr_mul"] == 0  # no kernel on the CPU


def test_kernel_header_constants_match_field_spec():
    """csrc/fields.cuh carries p, -p^-1 mod 2^32 and R mod p as literals;
    they must equal the FieldSpec values the plain path uses."""
    path = os.path.join(os.path.dirname(F.__file__), "..", "csrc",
                        "fields.cuh")
    src = open(path).read()
    blocks = re.findall(r"uint32_t (P|O)\[(\d+)\] = \{([^}]*)\}", src)
    n0s = [int(v, 16) for v in
           re.findall(r"N0 = (0x[0-9a-f]+)u", src)]
    words = {}
    for tag, n, body in blocks:
        vals = [int(v, 16) for v in re.findall(r"0x([0-9a-f]+)u", body)]
        words[(tag, int(n))] = sum(v << (32 * i) for i, v in enumerate(vals))
    assert words[("P", 8)] == FR_SPEC.modulus
    assert words[("P", 12)] == FQ_SPEC.modulus
    assert words[("O", 12)] == (1 << 384) % FQ_SPEC.modulus
    assert n0s == [(-pow(FR_SPEC.modulus, -1, 1 << 32)) % (1 << 32),
                   (-pow(FQ_SPEC.modulus, -1, 1 << 32)) % (1 << 32)]


def test_wrappers_check_their_operands():
    a = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_field.fr_mul(a, torch.zeros((8, 4), dtype=torch.int64))
    with pytest.raises(TypeError):
        cuda_field.fr_sqr(a.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_field.fr_mul(a[:6], a[:6])


def test_butterfly_matches_reference():
    """cuda_field.fr_butterfly (plain path on the CPU) against the
    reference's pallas_field.fr_butterfly (its plain branch below 256
    lanes), with the edge values on every side and a broadcast twiddle;
    and against Python ints."""
    from polymath_tpu.ops import pallas_field as PF
    p = FR_SPEC.modulus
    vlo, vhi = _values(FR_SPEC, 28, 13), _values(FR_SPEC, 28, 14)[::-1]
    vtw = _values(FR_SPEC, 28, 15)
    lo, hi, tw = (_mont(FR_SPEC, v) for v in (vlo, vhi, vtw))
    for name, t, tv in [("full", tw, vtw), ("broadcast", tw[:, -2:-1],
                                          [vtw[-2]] * len(vtw))]:
        want = PF.fr_butterfly(jnp.asarray(lo), jnp.asarray(hi),
                               jnp.asarray(t))
        got = cuda_field.fr_butterfly(limbs_to_words(_port(lo)),
                                      limbs_to_words(_port(hi)),
                                      limbs_to_words(_port(t)))
        for g, w in zip(got, want):
            assert g.shape == (8, len(vlo)), name
            np.testing.assert_array_equal(
                _ref(w), words_to_limbs(g).numpy(), err_msg=name)
        ints = [[FR_SPEC.from_mont_int(v) for v in words_to_ints(g.numpy())]
                for g in got]
        assert ints[0] == [(a + b * c) % p for a, b, c in zip(vlo, vhi, tv)]
        assert ints[1] == [(a - b * c) % p for a, b, c in zip(vlo, vhi, tv)]
    assert cuda_field.LAUNCHES["fr_butterfly"] == 0
    with pytest.raises(TypeError):
        cuda_field.fr_butterfly(_port(lo), _port(hi), _port(tw))  # limbs
