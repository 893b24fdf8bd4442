"""Port NTT (polymath_tpu_torch.ops.ntt) against the JAX reference's local
NTT (polymath_tpu.ops.ntt, its XLA path on the CPU) and against the host
Radix2Domain, bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polymath_tpu.ops import ntt as RN
from polymath_tpu.protocol.poly_host import Radix2Domain
from polymath_tpu.hostmath.bls12_381 import R
from polymath_tpu_torch.ops import ntt as PN
from polymath_tpu_torch.ops.limbs import (
    FR_SPEC, ints_to_limbs, ints_to_words, words_to_ints, words_to_limbs,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]


def _mont_words(vals):
    return torch.from_numpy(
        ints_to_words([FR_SPEC.to_mont_int(v) for v in vals], 16))


def _canon(words):
    return [FR_SPEC.from_mont_int(v) for v in words_to_ints(words.numpy())]


def test_plain_local_kernel_matches_reference_jnp():
    """The kernel's plain version against ntt._local_ntt_jnp, the XLA twin
    of the Pallas kernel, on bit-reversed input with per-stage twiddles."""
    nl, B = 16, 3
    vals = [FR_SPEC.to_mont_int(v) for v in _ints(B * nl, 5)]
    x = ints_to_limbs(vals, 16).reshape(16, B, nl)
    w = PN.domain_omega(nl)
    tw_lanes = np.stack([
        ints_to_limbs([FR_SPEC.to_mont_int(pow(w, (p & (m - 1)) * (nl // (2 * m)), R))
                       for p in range(nl)], 16)
        for m in (1 << s for s in range(4))], axis=1)     # (16, S, nl)
    want = np.asarray(RN._local_ntt_jnp(jnp.asarray(x), jnp.asarray(tw_lanes),
                                        nl)).astype(np.int64)
    tw = PN.local_twiddles(nl, False, torch.device("cpu"))
    got = PN.ntt_local_plain(torch.from_numpy(x.astype(np.int64)),
                             words_to_limbs(tw))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("n", [16, 128, 2048, 4096])
def test_ntt_matches_radix2_domain(n):
    vals = _ints(n, n + 1)
    dom = Radix2Domain(n)
    a = _mont_words(vals)
    ev = PN.ntt(a)
    assert _canon(ev) == dom.fft(vals)
    back = PN.ntt(ev, inverse=True)
    assert torch.equal(back, a)
    assert _canon(PN.ntt(a, inverse=True)) == dom.ifft(vals)


@pytest.mark.parametrize("inverse", [False, True])
def test_local_batched_rows_match_radix2_domain(inverse):
    nl, B = 16, 3
    vals = _ints(B * nl, 17)
    dom = Radix2Domain(nl)
    got = PN.ntt_local_batched(_mont_words(vals).reshape(8, B, nl), inverse)
    for r in range(B):
        row = vals[r * nl:(r + 1) * nl]
        assert _canon(got[:, r]) == (dom.ifft(row) if inverse
                                     else dom.fft(row))


def test_powers_and_poly_eval():
    x = 0x1234567890ABCDEF
    pw = PN.powers_of(_mont_words([x]), 37)
    assert _canon(pw) == [pow(x, i, R) for i in range(37)]
    coeffs = _ints(300, 7)
    got = PN.poly_eval_device(_mont_words(coeffs), _mont_words([x]))
    assert _canon(got) == [sum(c * pow(x, i, R) for i, c in enumerate(coeffs)) % R]
    assert PN.domain_omega(1 << 10) == RN.domain_omega(1 << 10)


@pytest.mark.parametrize("n, n1", [(16, 8), (32, 8), (64, 16), (128, 32),
                                   (256, 64), (512, 32), (1024, 64)])
def test_split_past_local_squared_matches_radix2_domain(n, n1):
    """The 4-step split with a wider first half than the square one, as
    2^23 (n1 = 4096 = 2 n2) and 2^24 take it at the default sizes: both
    directions against Radix2Domain."""
    vals = _ints(n, n + n1)
    dom = Radix2Domain(n)
    a = _mont_words(vals)
    ev = PN._ntt_4step(a, False, n1)
    assert _canon(ev) == dom.fft(vals)
    assert torch.equal(PN._ntt_4step(ev, True, n1), a)
    assert _canon(PN._ntt_4step(a, True, n1)) == dom.ifft(vals)


def test_split_past_four_local_squared_raises():
    """ntt refuses 2^25 points before it reads them (a stride-0 view)."""
    a = torch.zeros((8, 1), dtype=torch.int32).expand(8, 1 << 25)
    with pytest.raises(ValueError, match="past"):
        PN.ntt(a)


def test_default_split_reaches_2_to_the_24():
    """Up to 2^22 points both halves are at most 2048, as before; 2^23 and
    2^24 take a half of 4096, what one launch holds; 2^25 is refused."""
    assert [PN.split(1 << k) for k in (12, 21, 22, 23, 24)] == [
        (64, 64), (2048, 1024), (2048, 2048), (4096, 2048), (4096, 4096)]
    assert 2 * PN.MAX_LOCAL == PN.MAX_WIDE == 4096
    with pytest.raises(ValueError):
        PN.split(1 << 25)
