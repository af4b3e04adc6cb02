"""Transform-level bit-exactness tests for every NTT variant against the
big-int oracles (SURVEY.md §4: round-trip + oracle comparison per variant,
replacing the reference's in-binary self-checks NTT.cu:1495-1817)."""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qtesla_ntt.oracle import (intt_inverse_psi_merged, ntt_naive,
                               ntt_forward_psi_merged)
from qtesla_ntt.ops import ntt as N
from qtesla_ntt.ops.tables import get_tables


def _jit(fn, tbl, **kw):
    return jax.jit(functools.partial(fn, tbl=tbl, **kw))


def _rand(rng, tbl, batch=3):
    return rng.integers(0, tbl.q, (batch, tbl.n), dtype=np.uint32)


@pytest.fixture(scope="module", params=["smallprime", "qtesla-i"])
def tbl(request):
    return get_tables(request.param)


def test_gs_fwd_cyclic_matches_naive_bitrev(rng, tbl):
    x = _rand(rng, tbl)
    got = np.asarray(_jit(N.gs_fwd_cyclic, tbl)(x))
    want = ntt_naive(x[0], tbl.ps)[tbl.bitrev]
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


def test_ct_fwd_cyclic_matches_naive(rng, tbl):
    x = _rand(rng, tbl)
    fn = jax.jit(lambda v: N.ct_fwd_cyclic(N.bitrev_permute(v, tbl), tbl))
    got = np.asarray(fn(x))
    want = ntt_naive(x[0], tbl.ps)
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


def test_stockham_matches_naive(rng, tbl):
    x = _rand(rng, tbl)
    got = np.asarray(_jit(N.stockham_fwd, tbl)(x))
    want = ntt_naive(x[0], tbl.ps)
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


def test_matrix_matches_naive(rng, tbl):
    x = _rand(rng, tbl)
    got = np.asarray(_jit(N.matrix_ntt, tbl)(x))
    want = ntt_naive(x[0], tbl.ps)
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


def test_fourstep_matches_naive(rng, tbl):
    n1 = 4 if tbl.n == 32 else 32
    x = _rand(rng, tbl)
    got = np.asarray(_jit(N.fourstep_ntt, tbl, n1=n1)(x))
    want = ntt_naive(x[0], tbl.ps)
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


def test_merged_fwd_matches_scalar_model(rng, tbl):
    x = _rand(rng, tbl)
    got = np.asarray(_jit(N.ntt_fwd_merged, tbl)(x))
    for b in range(x.shape[0]):
        want = ntt_forward_psi_merged(x[b], tbl.ps)
        np.testing.assert_array_equal(got[b].astype(np.uint64), want)


def test_merged_inv_matches_scalar_model(rng, tbl):
    X = _rand(rng, tbl)
    got = np.asarray(_jit(N.intt_inv_merged, tbl)(X))
    want = intt_inverse_psi_merged(X[0], tbl.ps)
    np.testing.assert_array_equal(got[0].astype(np.uint64), want)


@pytest.mark.parametrize("fwd,inv,kw", [
    (N.ntt_fwd_merged, N.intt_inv_merged, {}),
    (N.stockham_fwd, N.stockham_inv, {}),
    (N.matrix_ntt, functools.partial(N.matrix_ntt, inverse=True), {}),
])
def test_roundtrips(rng, tbl, fwd, inv, kw):
    """Forward+inverse == identity (the reference's core self-check,
    NTT.cu:1522-1530 etc.)."""
    x = _rand(rng, tbl, batch=4)
    fn = jax.jit(lambda v: inv(fwd(v, tbl), tbl))
    np.testing.assert_array_equal(np.asarray(fn(x)), x)


def test_fourstep_roundtrip(rng, tbl):
    n1 = 4 if tbl.n == 32 else 32
    x = _rand(rng, tbl, batch=4)
    fn = jax.jit(lambda v: N.fourstep_intt(
        N.fourstep_ntt(v, tbl, n1=n1), tbl, n1=n1))
    np.testing.assert_array_equal(np.asarray(fn(x)), x)


def test_cyclic_gs_ct_roundtrip(rng, tbl):
    """GS fwd (nat->rev) then CT inv (rev->nat) with explicit n^{-1}."""
    x = _rand(rng, tbl, batch=4)
    fn = jax.jit(lambda v: N.ct_inv_cyclic(N.gs_fwd_cyclic(v, tbl), tbl))
    np.testing.assert_array_equal(np.asarray(fn(x)), x)


def test_bitrev_involution(rng, tbl):
    x = _rand(rng, tbl)
    fn = jax.jit(lambda v: N.bitrev_permute(N.bitrev_permute(v, tbl), tbl))
    np.testing.assert_array_equal(np.asarray(fn(x)), x)


def test_weighting_inverse(rng, tbl):
    """weight_ipsi_ninv(weight_psi(x)) == x * n^{-1}... i.e. the two
    weightings compose to the n^{-1} scale (psi powers cancel)."""
    x = _rand(rng, tbl)
    fn = jax.jit(lambda v: N.weight_ipsi_ninv(N.weight_psi(v, tbl), tbl))
    got = np.asarray(fn(x)).astype(object)
    want = (x.astype(object) * tbl.ps.n_inv) % tbl.q
    np.testing.assert_array_equal(got, want)


def test_pointwise_mul(rng, tbl):
    x = _rand(rng, tbl)
    y = _rand(rng, tbl)
    got = np.asarray(_jit(N.pointwise_mul, tbl)(x, y)).astype(object)
    np.testing.assert_array_equal(got,
                                  (x.astype(object) * y.astype(object)) % tbl.q)


def test_batch_shapes_arbitrary(rng, tbl):
    """Transforms operate on the last axis of any-rank batches (vmap-free
    broadcasting, the analog of the reference's blockIdx.x batching)."""
    x = rng.integers(0, tbl.q, (2, 3, tbl.n), dtype=np.uint32)
    got = np.asarray(_jit(N.ntt_fwd_merged, tbl)(x))
    flat = np.asarray(_jit(N.ntt_fwd_merged, tbl)(x.reshape(6, tbl.n)))
    np.testing.assert_array_equal(got.reshape(6, tbl.n), flat)


def test_fused_bitrev_weighting_ops(rng):
    """Fused bitrev x weighting (reference NTT.cu:494-509) == the explicit
    two-pass compositions, for both orders."""
    import jax
    from qtesla_ntt.ops import ntt as N
    from qtesla_ntt.ops.tables import get_tables
    tbl = get_tables("qtesla-iii-speed")
    v = jnp.asarray(rng.integers(0, tbl.q, (3, tbl.n), dtype=np.uint32))
    a = np.asarray(jax.jit(
        lambda u: N.bitrev_weight_ipsi_ninv(u, tbl))(v))
    b = np.asarray(jax.jit(
        lambda u: N.weight_ipsi_ninv(N.bitrev_permute(u, tbl), tbl))(v))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(jax.jit(lambda u: N.weight_psi_bitrev(u, tbl))(v))
    d = np.asarray(jax.jit(
        lambda u: N.bitrev_permute(N.weight_psi(u, tbl), tbl))(v))
    np.testing.assert_array_equal(c, d)
