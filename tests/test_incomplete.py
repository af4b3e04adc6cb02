"""Kyber-shaped incomplete negacyclic NTT (ops/incomplete.py): moduli with
q ≡ 1 (mod n) but NOT (mod 2n), which the main registry and the
reference's root ladder (main.cu:18-65) must reject — the ring splits
into n/2 quadratics and the pointwise stage becomes degree-1 products."""

import numpy as np
import pytest

from qtesla_ntt.ops.incomplete import (basemul_incomplete,
                                       incomplete_params, intt_incomplete,
                                       ntt_incomplete,
                                       polymul_incomplete_fn)


class _PS:
    def __init__(self, n, q):
        self.n, self.q = n, q


SHAPES = [(256, 3329),                    # ML-KEM
          pytest.param(512, 7681, marks=pytest.mark.slow)]   # NewHope


@pytest.mark.parametrize("n,q", SHAPES)
def test_incomplete_polymul_vs_schoolbook(rng, n, q):
    x = rng.integers(0, q, (3, n), dtype=np.uint32)
    y = rng.integers(0, q, (3, n), dtype=np.uint32)
    x[0, :] = q - 1                       # worst-case magnitudes
    y[0, :] = q - 1
    z = np.asarray(polymul_incomplete_fn(n, q)(x, y))
    from qtesla_ntt.utils import native
    if native.native_available():
        want = native.negacyclic_schoolbook(x, y, q)
    else:
        from qtesla_ntt.oracle import negacyclic_schoolbook
        want = np.stack([negacyclic_schoolbook(x[b], y[b], _PS(n, q))
                         for b in range(3)]).astype(np.uint32)
    np.testing.assert_array_equal(z, want)


@pytest.mark.slow
def test_incomplete_roundtrip_and_gammas(rng):
    import jax.numpy as jnp
    n, q = 256, 3329
    p = incomplete_params(n, q)
    x = rng.integers(0, q, (4, n), dtype=np.uint32)
    back = np.asarray(intt_incomplete(ntt_incomplete(jnp.asarray(x), p), p))
    np.testing.assert_array_equal(back, x)
    # the pair residues are exactly the roots of Y^(n/2) + 1, all distinct
    gam = [int(g) for g in np.asarray(p.gammas)]
    assert len(set(gam)) == n // 2
    assert all(pow(g, n // 2, q) == q - 1 for g in gam)
    # basemul by the spectrum of 1 is the identity
    one = np.zeros((1, n), dtype=np.uint32)
    one[0, 0] = 1
    One = ntt_incomplete(jnp.asarray(one), p)
    X = ntt_incomplete(jnp.asarray(x), p)
    np.testing.assert_array_equal(
        np.asarray(basemul_incomplete(X, jnp.broadcast_to(One, X.shape), p)),
        np.asarray(X))


def test_incomplete_rejects_wrong_modulus():
    with pytest.raises(ValueError, match="mod n"):
        incomplete_params(256, 3331)          # 3331 is not 1 mod 256
    # the MAIN registry rightly rejects the Kyber modulus (no 2n-th root):
    # the incomplete path is the only road for it
    from qtesla_ntt.params import ParamSet
    with pytest.raises(ValueError, match="2n"):
        ParamSet(name="kyber-nope", n=256, q=3329)


def _is_prime(m: int) -> bool:
    if m < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if m % p == 0:
            return m == p
    d, r = m - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, m)
        if x in (1, m - 1):
            continue
        for _ in range(r - 1):
            x = x * x % m
            if x == m - 1:
                break
        else:
            return False
    return True


@pytest.mark.slow
def test_incomplete_registration_space_fuzz(rng):
    """Registration-space sweep for the incomplete path (the analog of the
    main registry's prime fuzz): for several n, find primes with
    q ≡ 1 (mod n) but q ≢ 1 (mod 2n) — the exact class the complete
    registry rejects — and check bit-exactness vs the schoolbook oracle."""
    from qtesla_ntt.utils import native
    from qtesla_ntt.oracle import negacyclic_schoolbook

    checked = 0
    for n in (64, 128, 256):
        qs, k = [], 1
        while len(qs) < 3:
            q = k * n + 1
            # odd multiplier k => q = 1 mod n but q != 1 mod 2n
            if k % 2 == 1 and q > 3 * n and _is_prime(q):
                qs.append(q)
            k += 2
        for q in qs:
            assert (q - 1) % n == 0 and (q - 1) % (2 * n) != 0
            x = rng.integers(0, q, (2, n), dtype=np.uint32)
            y = rng.integers(0, q, (2, n), dtype=np.uint32)
            x[0, :] = q - 1
            y[0, :] = q - 1
            z = np.asarray(polymul_incomplete_fn(n, q)(x, y))
            if native.native_available():
                want = native.negacyclic_schoolbook(x, y, q)
            else:
                want = np.stack(
                    [negacyclic_schoolbook(x[b], y[b], _PS(n, q))
                     for b in range(2)]).astype(np.uint32)
            np.testing.assert_array_equal(z, want, err_msg=f"(n={n}, q={q})")
            checked += 1
    assert checked == 9

