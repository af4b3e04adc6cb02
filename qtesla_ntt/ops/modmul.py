"""Lane-parallel modular arithmetic on uint32 vectors for the jnp pipelines.

Replaces the reference's scalar device arithmetic (conditional-subtract
add/sub NTT.cu:33-47,454-470; Barrett reduction NTT.cu:341-361,379-452) with
vector formulations in plain 32-bit jnp (JAX runs without 64-bit types by
default), so 60-bit products of 30-bit residues are assembled from 16-bit
limbs, and the per-twiddle reduction uses Shoup's precomputed-quotient trick
(one mulhi + two mullo per constant-operand mulmod) instead of the
reference's MIU-based Barrett (main.cuh:20-21).  The fused GPU kernel
(ntt_pallas.py) takes the high word from the card's native instruction
instead.

Everything is written in plain jnp on uint32 so the exact same functions trace
under jit on GPU/CPU, inside interpret-mode Pallas kernels, and under
vmap/shard_map.
All functions keep residues canonical in [0, q).
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

__all__ = [
    "mulhi32",
    "mulhi32_sloppy",
    "widemul32",
    "add_mod",
    "sub_mod",
    "shoup_mulmod",
    "shoup_mulmod_lazy",
    "shoup_mulmod_sloppy",
    "reduce_u32",
    "sparse_reduce_plan",
    "fast_reduce_2q",
    "mulmod_barrett",
    "u32",
]

# numpy scalar (not a jnp array): inlines as a literal inside Pallas kernels
# instead of a captured device constant
_U16 = np.uint32(0xFFFF)


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def mulhi32(x, y):
    """High 32 bits of the 64-bit product of two uint32 vectors.

    16-bit limb decomposition: x*y = hh*2^32 + (hl+lh)*2^16 + ll.  All
    intermediates provably fit in uint32 (limbs < 2^16 so each partial
    product < 2^32; the mid-sum is <= 3*(2^16-1))."""
    x0 = x & _U16
    x1 = x >> 16
    y0 = y & _U16
    y1 = y >> 16
    ll = x0 * y0
    lh = x0 * y1
    hl = x1 * y0
    hh = x1 * y1
    mid = (ll >> 16) + (lh & _U16) + (hl & _U16)
    return hh + (lh >> 16) + (hl >> 16) + (mid >> 16)


def widemul32(x, y):
    """(hi, lo) 64-bit product of uint32 vectors as two uint32 vectors."""
    lo = x * y  # wraps mod 2^32 by XLA unsigned semantics
    return mulhi32(x, y), lo


def mulhi32_sloppy(x, y):
    """mulhi32 minus its carry assembly: returns hi - eps with
    eps in {0, 1, 2}.

    Drops the ll = x0*y0 partial product and the mid-sum carry entirely
    (their only contribution to the high word is a carry of at most 2),
    saving one multiply and the carry-propagation chain.  Only valid where
    the caller compensates the underestimate, e.g. shoup_mulmod_sloppy."""
    x1 = x >> 16
    y1 = y >> 16
    lh = (x & _U16) * y1
    hl = x1 * (y & _U16)
    return x1 * y1 + (lh >> 16) + (hl >> 16)


def shoup_mulmod_sloppy(x, w, w_shoup, q: int):
    """x*w mod q in [0, 4q), w a precomputed constant < q, x any uint32;
    requires 4q < 2^32.

    Harvey's lazy Shoup product with a sloppy (underestimating) mulhi:
    r = x*w - (hi - eps)*q = r_exact + eps*q with r_exact in [0, 2q) and
    eps in {0, 1, 2}, so r in [0, 4q) — one conditional subtract returns
    to the [0, 2q) range at 5 fewer ops than the exact chain."""
    hi = mulhi32_sloppy(x, w_shoup)
    return x * w - hi * jnp.uint32(q)


def add_mod(a, b, q: int):
    """(a + b) mod q for canonical inputs; conditional subtract
    (vector twin of reference _addModP, NTT.cu:454-459)."""
    s = a + b
    qv = jnp.uint32(q)
    return jnp.where(s >= qv, s - qv, s)


def sub_mod(a, b, q: int):
    """(a - b) mod q for canonical inputs; conditional add-back
    (vector twin of reference _subModP, NTT.cu:461-470)."""
    d = a - b  # wraps when b > a
    return jnp.where(a >= b, d, d + jnp.uint32(q))


def shoup_mulmod_lazy(x, w, w_shoup, q: int):
    """x*w mod q in [0, 2q), w a precomputed constant < q, x any uint32.

    Shoup's trick: with w' = floor(w*2^32/q), r = w*x - floor(w'*x/2^32)*q
    (mod 2^32) lies in [0, 2q).  One mulhi32 + two low multiplies."""
    hi = mulhi32(x, w_shoup)
    return x * w - hi * jnp.uint32(q)


def shoup_mulmod(x, w, w_shoup, q: int):
    """Canonical [0, q) Shoup mulmod."""
    r = shoup_mulmod_lazy(x, w, w_shoup, q)
    qv = jnp.uint32(q)
    return jnp.where(r >= qv, r - qv, r)


def reduce_u32(x, q: int, one_shoup: int):
    """Any uint32 -> x mod q via Shoup with w = 1 (one_shoup = floor(2^32/q))."""
    return shoup_mulmod(x, jnp.uint32(1), jnp.uint32(one_shoup), q)


@functools.lru_cache(maxsize=None)
def sparse_reduce_plan(q: int):
    """Shift-add reduction plan for sparse q = 2^a + sum(2^b) + 1 (the
    qTESLA moduli 8404993 = 2^23+2^14+1 and 65537 = 2^16+1 qualify; the
    vector twin of the reference's shift-add Barrett, NTT.cu:341-361).

    With hi = x >> a and lo = x & (2^a - 1):
        x = hi*2^a + lo == lo - sum_b (hi << b) - hi   (mod q),
    all terms int32-exact.  Returns (a, mids, k, ncsub) such that
    r + k*q >= 0 and ncsub conditional subtracts by 2q land in [0, 2q);
    None when q isn't sparse or a bound would overflow int32."""
    bits = [i for i in range(q.bit_length()) if (q >> i) & 1]
    if not bits or bits[0] != 0 or len(bits) > 5 or len(bits) < 2:
        return None
    a, mids = bits[-1], bits[1:-1]
    himax = (1 << (32 - a)) - 1
    negmax = himax * (sum(1 << b for b in mids) + 1)
    if negmax >= 1 << 31 or any(himax << b >= 1 << 31 for b in mids):
        return None
    k = -(-negmax // q)
    bound = k * q + (1 << a)
    if bound >= 1 << 31:
        return None
    ncsub = 0
    while bound > 2 * q:
        bound = max(2 * q, bound - 2 * q)
        ncsub += 1
    return a, tuple(mids), k, ncsub


def fast_reduce_2q(x, q: int, one_shoup: int):
    """Any uint32 -> congruent value in [0, 2q).  Uses the sparse shift-add
    plan when q qualifies (6-10 ops, no multiply), else a sloppy Shoup by 1
    plus one conditional subtract."""
    plan = sparse_reduce_plan(q)
    if plan is None:
        r = shoup_mulmod_sloppy(x, jnp.uint32(1), jnp.uint32(one_shoup), q)
        return jnp.where(r >= jnp.uint32(2 * q), r - jnp.uint32(2 * q), r)
    a, mids, k, ncsub = plan
    hi = (x >> np.uint32(a)).astype(jnp.int32)
    r = (x & np.uint32((1 << a) - 1)).astype(jnp.int32) - hi
    for b in mids:
        r = r - (hi << np.int32(b))
    r = (r + np.int32(k * q)).astype(jnp.uint32)
    for _ in range(ncsub):
        r = jnp.where(r >= np.uint32(2 * q), r - np.uint32(2 * q), r)
    return r


def mulmod_barrett(x, y, q: int, r32: int, r32_shoup: int, one_shoup: int):
    """Generic (variable x variable) mulmod, exact for ANY uint32 x, y
    (q < 2^30).  The flagship and pairing kernels rely on this: their
    DIT/lazy intermediates are < 4q, not canonical.

    Assemble the 64-bit product as (hi, lo) — widemul32 is exact for any
    uint32 inputs — then fold:
        x*y mod q = (hi * (2^32 mod q) + lo) mod q
    with both folds done by Shoup mulmods (shoup_mulmod is exact
    unconditionally in its variable operand).  Used for the pointwise
    (Hadamard) multiply (reference pointwise_mult, NTT.cu:1155-1160) where
    neither operand is a precomputed constant."""
    hi, lo = widemul32(x, y)
    a = shoup_mulmod(hi, jnp.uint32(r32), jnp.uint32(r32_shoup), q)
    b = reduce_u32(lo, q, one_shoup)
    return add_mod(a, b, q)
