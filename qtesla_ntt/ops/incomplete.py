"""Incomplete (Kyber-shaped) negacyclic NTT polymul: q ≡ 1 (mod n) but
NOT (mod 2n).

The reference's root ladder (main.cu:18-65) and this repo's main registry
(params.ParamSet) both require a 2n-th root of unity — X^n + 1 splits into
linear factors.  ML-KEM's modulus q = 3329 has only a 256-th root, so for
n = 256 the ring splits into n/2 QUADRATICS X² − γ_i instead: the NTT runs
log2(n) − 1 butterfly levels (one short of complete) and the pointwise
stage becomes a degree-1 polynomial product per pair,

    (a0 + a1 X)(b0 + b1 X) ≡ (a0 b0 + γ_i a1 b1) + (a0 b1 + a1 b0) X
                                                    (mod X² − γ_i).

Everything is derived from (n, q) with exact integers at build time:
ζ = g^((q-1)/n) (primitive n-th root), per-level forward twiddles in the
standard bit-reversed block order, and the pair residues γ_i extracted
SELF-CONSISTENTLY by pushing X² through the forward transform (pair i of
NTT(X²) is (γ_i, 0) by definition of evaluation mod X² − γ_i) — so the
basemul can never disagree with the transform's own output order.  The
inverse runs the exact mirror butterflies (u, v) -> (u+v, z^{-1}(u-v))
with the deferred (n/2)^{-1} folded into one final scaling.

This is the correctness/reference path (jnp, generic Barrett mulmods —
like the repo's matrix/four-step jnp variants); a fused kernel for the
incomplete transform is future work (the basemul becomes a lane-pair
cross product).

Compute path: plain jnp under jit — runs on GPU/CPU unchanged.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

from ..params import _find_generator, _is_pow2
from .modmul import add_mod, mulmod_barrett, sub_mod

__all__ = ["incomplete_params", "ntt_incomplete", "intt_incomplete",
           "basemul_incomplete", "polymul_incomplete_fn"]


@functools.lru_cache(maxsize=None)
def incomplete_params(n: int, q: int):
    """Exact tables for the incomplete negacyclic NTT over (n, q) with
    q ≡ 1 (mod n).  Works for complete-capable q too (it simply never
    uses a 2n-th root), but the point is moduli the main registry must
    reject — q ≡ 1 (mod n), q ≢ 1 (mod 2n)."""
    if not _is_pow2(n) or n < 4:
        raise ValueError(f"n={n} must be a power of two >= 4")
    if (q - 1) % n != 0:
        raise ValueError(f"q={q} must satisfy q ≡ 1 (mod n), n={n}")
    if q >= 1 << 30:
        raise ValueError(f"q={q} must be < 2^30 for the int32-lane path")
    g = _find_generator(q)
    zeta = pow(g, (q - 1) // n, q)          # primitive n-th root
    assert pow(zeta, n // 2, q) == q - 1    # zeta^(n/2) = -1
    L = n.bit_length() - 2                  # levels = log2(n) - 1
    bits = L                                # br over the twiddle index
    # zetas[k] = zeta^bitrev_L(k); per-level forward twiddles are the
    # standard contiguous slices zs[l] = zetas[2^l : 2^(l+1)]
    def br(x, b):
        r = 0
        for _ in range(b):
            r = (r << 1) | (x & 1)
            x >>= 1
        return r
    zetas = [pow(zeta, br(k, bits), q) for k in range(1 << bits)]
    # the negacyclic offset: level-l block twiddles are odd powers
    # zeta^(2*br+1)/2-structure in the standard formulation; deriving them
    # as zeta^br(k) over k >= 1 reproduces Kyber's table exactly because
    # br runs over the shifted index (k in [2^l, 2^(l+1)))
    zs = [np.array(zetas[1 << l:2 << l], dtype=np.uint32)
          for l in range(L)]
    p = types.SimpleNamespace(
        n=n, q=q, g=g, zeta=zeta, L=L,
        zs=[jnp.asarray(z) for z in zs],
        zs_inv=[jnp.asarray(np.array([pow(int(w), -1, q) for w in z],
                                     dtype=np.uint32)) for z in zs],
        half_inv=pow(n // 2, -1, q),
        r32=(1 << 32) % q,
        r32_shoup=(((1 << 32) % q) << 32) // q,
        one_shoup=(1 << 32) // q,
    )
    # pair residues γ_i, self-derived: NTT(X^2) pair i = (γ_i, 0)
    x2 = np.zeros((1, n), dtype=np.uint32)
    x2[0, 2] = 1
    spec = np.asarray(ntt_incomplete(jnp.asarray(x2), p))[0]
    gam = spec[0::2].astype(np.int64)
    assert not spec[1::2].any(), "NTT(X^2) pairs must be (gamma, 0)"
    # the γ_i are exactly the roots of Y^(n/2) + 1
    for gi in gam[: min(8, len(gam))]:
        assert pow(int(gi), n // 2, q) == q - 1
    p.gammas = jnp.asarray(gam.astype(np.uint32))
    return p


def _mul(x, y, p):
    return mulmod_barrett(x, y, p.q, p.r32, p.r32_shoup, p.one_shoup)


def ntt_incomplete(a, p):
    """Forward incomplete NTT, (B, n) canonical -> (B, n) canonical:
    L = log2(n)-1 CT levels (u, v) -> (u + z v, u - z v)."""
    B = a.shape[0]
    n, q = p.n, p.q
    for l in range(p.L):
        half = n >> (l + 1)
        v4 = a.reshape(B, 1 << l, 2, half)
        z = p.zs[l][None, :, None]
        t = _mul(v4[:, :, 1, :], z, p)
        lo = add_mod(v4[:, :, 0, :], t, q)
        hi = sub_mod(v4[:, :, 0, :], t, q)
        a = jnp.stack([lo, hi], axis=2).reshape(B, n)
    return a


def intt_incomplete(a, p):
    """Inverse: mirror butterflies (x, y) -> (x + y, z^{-1}(x - y)), one
    deferred (n/2)^{-1} scaling at the end."""
    B = a.shape[0]
    n, q = p.n, p.q
    for l in range(p.L - 1, -1, -1):
        half = n >> (l + 1)
        v4 = a.reshape(B, 1 << l, 2, half)
        x, y = v4[:, :, 0, :], v4[:, :, 1, :]
        u = add_mod(x, y, q)
        v = _mul(sub_mod(x, y, q), p.zs_inv[l][None, :, None], p)
        a = jnp.stack([u, v], axis=2).reshape(B, n)
    return _mul(a, jnp.uint32(p.half_inv), p)


def basemul_incomplete(A, Bv, p):
    """Pairwise degree-1 products mod (X² − γ_i): the incomplete
    transform's pointwise stage (the analog of the reference's
    pointwise_mult, NTT.cu:1155-1160)."""
    B = A.shape[0]
    a = A.reshape(B, -1, 2)
    b = Bv.reshape(B, -1, 2)
    a0, a1 = a[:, :, 0], a[:, :, 1]
    b0, b1 = b[:, :, 0], b[:, :, 1]
    gam = p.gammas[None, :]
    c0 = add_mod(_mul(a0, b0, p), _mul(gam, _mul(a1, b1, p), p), p.q)
    c1 = add_mod(_mul(a0, b1, p), _mul(a1, b0, p), p.q)
    return jnp.stack([c0, c1], axis=2).reshape(B, p.n)


@functools.lru_cache(maxsize=None)
def polymul_incomplete_fn(n: int, q: int):
    """Jitted negacyclic polymul z = x·y mod (X^n + 1, q) for
    Kyber-shaped moduli (q ≡ 1 mod n only): (B, n) x (B, n) -> (B, n)."""
    p = incomplete_params(n, q)

    def fn(x, y):
        x = jnp.asarray(x, jnp.uint32)
        y = jnp.asarray(y, jnp.uint32)
        shape = x.shape
        x = x.reshape(-1, n)
        y = y.reshape(-1, n)
        Z = basemul_incomplete(ntt_incomplete(x, p),
                               ntt_incomplete(y, p), p)
        return intt_incomplete(Z, p).reshape(shape)

    return jax.jit(fn)
