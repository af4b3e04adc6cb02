"""Nussbaumer path tests: Z_{2^32-1} ring arithmetic, the tensorized
convolution vs the big-int ring oracle, and the NTT-vs-Nussbaumer
cross-check (the reference's independent-algorithm validation, SURVEY.md §4)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qtesla_ntt.ops import ringz32 as R
from qtesla_ntt.ops.nussbaumer import (nussbaumer_negacyclic_ring,
                                       polymul_nussbaumer_fn)
from qtesla_ntt.models import polymul_negacyclic
from qtesla_ntt.oracle import (negacyclic_schoolbook,
                               negacyclic_schoolbook_ring)
from qtesla_ntt.params import get_params

M = (1 << 32) - 1


def test_ring_ops_vs_bigint(rng):
    a = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    a[:2] = [0xFFFFFFFF, 0]
    b[:2] = [0xFFFFFFFF, 0xFFFFFFFF]
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ao, bo = a.astype(object), b.astype(object)

    def norm(v):
        return np.asarray(jax.jit(R.ring_normalize)(v)).astype(object) % M

    np.testing.assert_array_equal(norm(jax.jit(R.ring_add)(ja, jb)),
                                  (ao + bo) % M)
    np.testing.assert_array_equal(norm(jax.jit(R.ring_sub)(ja, jb)),
                                  (ao - bo) % M)
    np.testing.assert_array_equal(norm(jax.jit(R.ring_mul)(ja, jb)),
                                  (ao * bo) % M)
    np.testing.assert_array_equal(norm(jax.jit(R.ring_neg)(ja)), (-ao) % M)
    inv2 = pow(2, -1, M)
    np.testing.assert_array_equal(norm(jax.jit(R.ring_div2)(ja)),
                                  (ao * inv2) % M)


@pytest.mark.parametrize("n", [32, 64,
                               pytest.param(512, marks=pytest.mark.slow)])
def test_nussbaumer_ring_vs_oracle(rng, n):
    x = rng.integers(0, 100000, (2, n)).astype(np.uint32)
    y = rng.integers(0, 100000, (2, n)).astype(np.uint32)
    z = np.asarray(jax.jit(nussbaumer_negacyclic_ring)(
        jnp.asarray(x), jnp.asarray(y)))
    for b in range(2):
        want = negacyclic_schoolbook_ring(x[b], y[b])
        np.testing.assert_array_equal(z[b].astype(np.uint64), want)


@pytest.mark.parametrize("name", [
    "smallprime",
    pytest.param("qtesla-iii-speed", marks=pytest.mark.slow),
    pytest.param("qtesla-p-iii", marks=pytest.mark.exhaustive)])
def test_nussbaumer_vs_ntt_crosscheck(rng, name):
    """Independent-algorithm cross-check, small operands (the Nussbaumer
    exactness domain — same restriction as the reference's Z_{2^32-1} path)."""
    ps = get_params(name)
    x = rng.integers(0, 512, (2, ps.n)).astype(np.uint32)
    y = rng.integers(0, 512, (2, ps.n)).astype(np.uint32)
    za = np.asarray(polymul_nussbaumer_fn(name, max_coeff=511)(x, y))
    zb = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(za, zb)


def test_nussbaumer_via_models_api(rng):
    ps = get_params("smallprime")
    x = rng.integers(0, 40, (3, ps.n)).astype(np.uint32)
    y = rng.integers(0, 40, (3, ps.n)).astype(np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="nussbaumer"))
    want = negacyclic_schoolbook(x[0], y[0], ps)
    np.testing.assert_array_equal(z[0].astype(np.uint64), want)


@pytest.mark.slow
def test_nussbaumer_negative_wrap():
    """Signed recovery: products whose true coefficients are negative."""
    ps = get_params("qtesla-iii-speed")
    n = ps.n
    x = np.zeros((1, n), np.uint32)
    y = np.zeros((1, n), np.uint32)
    x[0, 0], x[0, 1] = 1, 2
    y[0, n - 1] = 7          # x*y has -14 X^0 and -7? wrap terms
    z = np.asarray(polymul_nussbaumer_fn(ps.name, max_coeff=7)(x, y))
    want = negacyclic_schoolbook(x[0], y[0], ps)
    np.testing.assert_array_equal(z[0].astype(np.uint64), want)


def test_nussbaumer_ring_out_of_domain_raises():
    """The ring path must refuse declared operand bounds
    outside its provable exactness domain instead of returning silently
    wrong results."""
    from qtesla_ntt.ops.nussbaumer import ring_exact_coeff_bound
    limit = ring_exact_coeff_bound(1024)
    with pytest.raises(ValueError, match="exact only"):
        polymul_nussbaumer_fn("qtesla-iii-speed")          # full range
    with pytest.raises(ValueError, match="exact only"):
        polymul_nussbaumer_fn("qtesla-iii-speed", max_coeff=limit + 1)
    polymul_nussbaumer_fn("qtesla-iii-speed", max_coeff=limit)  # ok


@pytest.mark.parametrize("name", [
    "smallprime",
    pytest.param("qtesla-iii-speed", marks=pytest.mark.exhaustive),
    pytest.param("qtesla-p-iii", marks=pytest.mark.exhaustive)])
def test_nussbaumer_modq_full_range(rng, name):
    """The exact mod-q recursion has NO domain restriction: full-range
    random operands and adversarial all-(q-1) operands, vs big-int oracle."""
    ps = get_params(name)
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    x[1, :] = ps.q - 1
    y[1, :] = ps.q - 1
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="nussbaumer"))
    for b in range(2):
        want = negacyclic_schoolbook(x[b], y[b], ps)
        np.testing.assert_array_equal(z[b].astype(np.uint64), want)


@pytest.mark.slow
def test_nussbaumer_batch_chunking(rng):
    """Large batches run as a sequential lax.map over fixed chunks (the
    single-shot pipeline's intermediates grow with the batch) — the chunked
    path (bulk map + remainder) must be bit-identical to the single-shot
    path."""
    from qtesla_ntt.ops.nussbaumer import (_chunked_pairs,
                                           nussbaumer_negacyclic_modq)
    ps = get_params("smallprime")
    B = 7                          # chunk=2: 3 mapped chunks + remainder 1
    x = jnp.asarray(rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32))
    y = jnp.asarray(rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32))

    def body(a, b):
        return nussbaumer_negacyclic_modq(a, b, ps)

    whole = np.asarray(body(x, y))
    chunked = np.asarray(_chunked_pairs(body, x, y, chunk=2))
    np.testing.assert_array_equal(chunked, whole)


@pytest.mark.slow
def test_karatsuba_base_products_match_schoolbook(rng):
    """The negacyclic-Karatsuba base products (9/16 the multiplies) must be
    bit-identical to the reference-shaped schoolbook (smallprime keeps it
    in the fast tier; the ring variant is the slow-tier twin below)."""
    from qtesla_ntt.ops.nussbaumer import nussbaumer_negacyclic_modq
    ps = get_params("smallprime")
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    a = np.asarray(nussbaumer_negacyclic_modq(x, y, ps, base="schoolbook"))
    b = np.asarray(nussbaumer_negacyclic_modq(x, y, ps, base="karatsuba"))
    assert (a == b).all()


@pytest.mark.slow
def test_karatsuba_matches_schoolbook_ring(rng):
    """Same A/B over the Z_{2^32-1} end-around-carry arithmetic."""
    from qtesla_ntt.ops.nussbaumer import nussbaumer_negacyclic_ring
    xr = rng.integers(0, 500, (2, 64), dtype=np.uint32)
    yr = rng.integers(0, 500, (2, 64), dtype=np.uint32)
    c = np.asarray(nussbaumer_negacyclic_ring(xr, yr, base="schoolbook"))
    d = np.asarray(nussbaumer_negacyclic_ring(xr, yr, base="karatsuba"))
    assert (c == d).all()


@pytest.mark.exhaustive
def test_karatsuba_matches_schoolbook_qtesla_iii(rng):
    from qtesla_ntt.ops.nussbaumer import nussbaumer_negacyclic_modq
    ps = get_params("qtesla-iii-speed")
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    a = np.asarray(nussbaumer_negacyclic_modq(x, y, ps, base="schoolbook"))
    b = np.asarray(nussbaumer_negacyclic_modq(x, y, ps, base="karatsuba"))
    assert (a == b).all()
