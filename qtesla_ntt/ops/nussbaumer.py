"""Batched Nussbaumer negacyclic convolution over Z_{2^32-1} and Z_q.

NTT-free alternative path (reference nussbaumer_fft, NTT.cu:147-277) used to
cross-check the NTT pipelines.  The reference's pointer-chasing recursion over
malloc'd row arrays is restructured as fixed-shape tensor ops (SURVEY.md §7
step 6) in a *lanes=batch* layout: the state is a (2m, r, B) array with the
batch in the minor dimension, so every arithmetic op runs at full vector
width regardless of r.  Because the butterfly pairings are contiguous row
runs and every twiddle is a monomial w^s, the entire transform lowers to
static slices + concats — zero gathers, zero dynamic indexing:

- a butterfly level is, per group, two contiguous row-block slices combined
  segment-wise along the r axis; the negacyclic wrap's sign flip is folded
  into swapping add<->sub on the wrapped segment (no negation op is ever
  materialized);
- the 2m base multiplications are schoolbook negacyclic r-point products,
  statically unrolled: each term is a cyclic concat-roll of Y along the
  sublane (r) axis, one elementwise multiply, and a segment-split
  add/subtract into the accumulator;
- the 1/2 halvings of the inverse butterflies are deferred and applied once
  at the end as a single multiplication by 2^-(log2(m)+1) (a bit-rotation in
  Z_{2^32-1} since 2^32 === 1; one constant Shoup mulmod in Z_q).

Math: to multiply in Z[X]/(X^n + 1) with n = m * r (m <= r, both powers of
two), write x as m polynomials X_i(w) of length r (X_i[j] = x[j*m + i]),
duplicate to 2m rows, run a 2m-point DFT over Z[w]/(w^r + 1) where the
2m-th root of unity is the *monomial* w^(r/m) — multiplication by it is a
negacyclic shift, no multiplies.  Pointwise negacyclic r-products, inverse
butterflies (halving deferred), recombine:
z[m*j + i] = Z_i[j] + Z_{m+i}[j-1] (negacyclic wrap at j=0).

Arithmetic in the Z_{2^32-1} ring is exact whenever the true integer
coefficients of the product are < 2^32-1 in magnitude — the reference has the
same domain restriction (qTESLA's sparse/small multiplicands; SURVEY.md C19
note).  The Z_q variant is exact for all operands.
"""

from __future__ import annotations

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np

from .modmul import mulmod_barrett, reduce_u32, shoup_mulmod, u32
from .ringz32 import RING_MOD, ring_add, ring_mul, ring_normalize, ring_sub

__all__ = ["nussbaumer_negacyclic_ring", "nussbaumer_negacyclic_modq",
           "polymul_nussbaumer_fn", "polymul_nussbaumer_q_fn",
           "nussbaumer_plan", "ring_exact_coeff_bound"]


# ----------------------------------------------------------------------
# Coefficient arithmetic hooks.  The butterfly/base-product machinery below
# is generic over the coefficient ring: Z_{2^32-1} (the reference's exact
# integer ring, NTT.cu:102-145) or Z_q directly (exact for ALL operands —
# the guard-free variant the reference lacks).  Each namespace provides
# add/sub/mul plus scale_pow2_inv(v, k) = v * 2^-k, the deferred inverse
# halvings applied once.
# ----------------------------------------------------------------------


def _ring_scale_pow2_inv(v, k: int):
    """v * 2^-k mod 2^32-1: since 2^32 === 1, this is a right-rotation by
    k bits (exact; preserves the double representation of zero)."""
    k = k % 32
    if k == 0:
        return v
    return (v >> np.uint32(k)) | (v << np.uint32(32 - k))


_RING_ARITH = types.SimpleNamespace(
    add=ring_add, sub=ring_sub, mul=ring_mul,
    scale_pow2_inv=_ring_scale_pow2_inv,
)


def _modq_arith(q: int, r32: int, r32_shoup: int, one_shoup: int):
    """Z_q arithmetic for the Nussbaumer recursion (q odd, < 2^31):
    conditional-subtract add/sub, full Barrett mulmods for the base
    products, and a single constant Shoup mulmod for the deferred
    2^-k scale."""
    qv = jnp.uint32(q)

    def add(a, b):
        s = a + b
        return jnp.where(s >= qv, s - qv, s)

    def sub(a, b):
        d = a - b
        return jnp.where(a >= b, d, d + qv)

    def mul(a, b):
        return mulmod_barrett(a, b, q, r32, r32_shoup, one_shoup)

    def scale_pow2_inv(v, k):
        c = pow(2, -k, q)
        return shoup_mulmod(v, jnp.uint32(c), jnp.uint32((c << 32) // q), q)

    return types.SimpleNamespace(add=add, sub=sub, mul=mul,
                                 scale_pow2_inv=scale_pow2_inv)


def _bitrev(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


@functools.lru_cache(maxsize=None)
def nussbaumer_plan(n: int):
    """Static plan: (m, r, fwd, inv).  fwd/inv are level tuples; each level
    is a tuple of groups (start, width, shift): rows [start, start+width)
    are the butterfly's 'a' half, rows [start+width, start+2*width) the 'b'
    half, and `shift` is the monomial exponent s of the twiddle w^s (forward
    levels twiddle b before combining; inverse levels twiddle the difference
    by w^-s after).  Groups tile the 2m rows contiguously in order, so a
    level's output is the in-order concat of its per-group outputs."""
    logn = n.bit_length() - 1
    logm = logn // 2
    m = 1 << logm
    r = n // m
    assert m * r == n and m <= r
    unit = r // m                       # w^(r/m) is the 2m-th root
    fwd = []
    for j in range(logm - 1, -1, -1):
        groups = []
        for i in range(1 << (logm - j)):
            start = i << (j + 1)
            shift = (_bitrev(i, logm - j) << j) * unit
            groups.append((start, 1 << j, shift))
        fwd.append(tuple(groups))

    # inverse runs the forward levels in reverse order, then one extra
    # level pairing rows (i, m+i) at shift 0 to undo the input duplication
    inv = [fwd[logm - 1 - j] for j in range(logm)]
    inv.append(((0, m, 0),))

    return m, r, tuple(fwd), tuple(inv)


def _fwd_level(state, groups, r: int, A):
    """One forward butterfly level on (2m, r, B) state.

    Per group: b = w^s * b_raw has b[:s] = -b_raw[r-s:], b[s:] = b_raw[:r-s]
    along the r axis; the sign folds into swapping add<->sub on the wrapped
    segment, so the twiddle costs nothing beyond the slicing."""
    outs = []
    for start, w, s in groups:
        a = state[start:start + w]
        b = state[start + w:start + 2 * w]
        if s == 0:
            outs.append(A.add(a, b))
            outs.append(A.sub(a, b))
        else:
            outs.append(jnp.concatenate(
                [A.sub(a[:, :s], b[:, r - s:]),
                 A.add(a[:, s:], b[:, :r - s])], axis=1))
            outs.append(jnp.concatenate(
                [A.add(a[:, :s], b[:, r - s:]),
                 A.sub(a[:, s:], b[:, :r - s])], axis=1))
    return jnp.concatenate(outs, axis=0)


def _inv_level(state, groups, r: int, A):
    """One inverse butterfly level (halving deferred to the final scale).

    Per group: sum = a + b; diff twiddled by w^-s is
    out_d[j] = d[j+s] for j < r-s and -d[j-(r-s)] for j >= r-s, with the
    negation folded as d -> sub(b, a) on the wrapped segment."""
    outs = []
    for start, w, s in groups:
        a = state[start:start + w]
        b = state[start + w:start + 2 * w]
        outs.append(A.add(a, b))
        if s == 0:
            outs.append(A.sub(a, b))
        else:
            outs.append(jnp.concatenate(
                [A.sub(a[:, s:], b[:, s:]),
                 A.sub(b[:, :s], a[:, :s])], axis=1))
    return jnp.concatenate(outs, axis=0)


def _base_negacyclic(X, Y, r: int, A):
    """Schoolbook negacyclic r-point products on (2m, r, B) rows:
    z[:, i, :] = sum_j sign(i,j) * X[:, j, :] * Y[:, (i-j) mod r, :],
    statically unrolled over j (replaces the reference's `naive`,
    NTT.cu:147-165).  Each term is a cyclic concat-roll of Y along the
    sublane axis; the negacyclic sign (output rows i < j) folds into
    subtracting that segment from the accumulator."""
    acc = A.mul(X[:, 0:1, :], Y)
    for j in range(1, r):
        rolled = jnp.concatenate([Y[:, r - j:, :], Y[:, :r - j, :]], axis=1)
        prod = A.mul(X[:, j:j + 1, :], rolled)
        acc = jnp.concatenate([A.sub(acc[:, :j], prod[:, :j]),
                               A.add(acc[:, j:], prod[:, j:])], axis=1)
    return acc


def _acyclic_schoolbook(X, Y, h: int, A):
    """Plain (acyclic) product of length-h row polynomials on (R, h, B)
    state -> (R, 2h-1, B): h row multiplies, accumulated with static
    slice/concat assembly (no zero padding, no gathers)."""
    acc = A.mul(X[:, 0:1, :], Y)                       # width h
    for j in range(1, h):
        prod = A.mul(X[:, j:j + 1, :], Y)
        # acc width h+j-1; overlap acc[:, j:] with prod[:, :h-1]
        acc = jnp.concatenate(
            [acc[:, :j], A.add(acc[:, j:], prod[:, :h - 1]),
             prod[:, h - 1:]], axis=1)
    return acc


_KARATSUBA_CUTOFF = 8   # schoolbook below this width (A/B'd on device)


def _acyclic(X, Y, h: int, A, cutoff: int | None = None):
    """Acyclic product with Karatsuba recursion: 3 half-length products
    (low, high, (lo+hi)x(lo+hi)) + slice/concat assembly — 3/4 the row
    multiplies per level, down to the schoolbook cutoff."""
    if cutoff is None:
        cutoff = _KARATSUBA_CUTOFF
    if h <= cutoff or h % 2:
        return _acyclic_schoolbook(X, Y, h, A)
    g = h // 2
    X0, X1 = X[:, :g], X[:, g:]
    Y0, Y1 = Y[:, :g], Y[:, g:]
    P0 = _acyclic(X0, Y0, g, A, cutoff)                # width 2g-1
    P1 = _acyclic(X1, Y1, g, A, cutoff)
    Pm = _acyclic(A.add(X0, X1), A.add(Y0, Y1), g, A, cutoff)
    Mm = A.sub(A.sub(Pm, P0), P1)                      # middle, width 2g-1
    # result[t] = P0[t] + Mm[t-g] + P1[t-2g], width 2h-1 = 4g-1:
    #   [0, g)        P0 low half
    #   [g, 2g-1)     P0 high + Mm low
    #   {2g-1}        Mm[g-1]                (P0/P1 have no 2g-1 term)
    #   [2g, 3g-1)    Mm high + P1 low
    #   [3g-1, 4g-1)  P1 high
    return jnp.concatenate(
        [P0[:, :g],
         A.add(P0[:, g:], Mm[:, :g - 1]),
         Mm[:, g - 1:g],
         A.add(Mm[:, g:], P1[:, :g - 1]),
         P1[:, g - 1:]], axis=1)


def _base_negacyclic_karatsuba(X, Y, r: int, A):
    """Negacyclic r-point base products via one negacyclic Karatsuba split
    (X = X0 + w^h X1, h = r/2; w^r = -1) over acyclic Karatsuba products:

        Z = (X0Y0 - X1Y1) + w^h ((X0+X1)(Y0+Y1) - X0Y0 - X1Y1)

    with the w^h overflow (positions >= r) wrapping negacyclically.  Row
    multiplies: 27 at r=32 (3 acyclic 16-products, each 3x schoolbook-8)
    vs the plain schoolbook's 32 — and each is half/quarter width, so the
    scalar multiply count is 9/16 of schoolbook (the multiplies are the
    expensive op: a full Barrett mod-q mul is ~15 integer ops vs ~3 for
    add/sub).  The extra adds are assembly slices, all static."""
    h = r // 2
    X0, X1 = X[:, :h], X[:, h:]
    Y0, Y1 = Y[:, :h], Y[:, h:]
    P0 = _acyclic(X0, Y0, h, A)                        # width 2h-1 = r-1
    P1 = _acyclic(X1, Y1, h, A)
    Pm = _acyclic(A.add(X0, X1), A.add(Y0, Y1), h, A)
    Aa = A.sub(P0, P1)                                 # w^0 part
    Mm = A.sub(A.sub(Pm, P0), P1)                      # w^h part
    # Z[j]     = Aa[j] - Mm[h+j]   j in [0, h-1)   (w^(h+t), t>=h wraps -)
    # Z[h-1]   = Aa[h-1]
    # Z[h+j]   = Aa[h+j] + Mm[j]  j in [0, h-1)
    # Z[2h-1]  = Mm[h-1]
    return jnp.concatenate(
        [A.sub(Aa[:, :h - 1], Mm[:, h:]),
         Aa[:, h - 1:h],
         A.add(Aa[:, h:], Mm[:, :h - 1]),
         Mm[:, h - 1:h]], axis=1)


def _nussbaumer(x, y, A, base: str = "karatsuba"):
    """Generic negacyclic product over the coefficient arithmetic A.
    x, y: (..., n); internally (2m, r, B) with the flattened batch in
    lanes.  `base` selects the base-product algorithm: 'karatsuba'
    (negacyclic split + recursive acyclic Karatsuba, 9/16 the multiplies)
    or 'schoolbook' (the reference-shaped r^2 loop, NTT.cu:147-165)."""
    n = x.shape[-1]
    m, r, fwd, inv = nussbaumer_plan(n)
    batch = x.shape[:-1]
    logm = m.bit_length() - 1

    def lift(v):
        # X_i[j] = v[j*m + i]: (B, r, m) -> (m, r, B), duplicated to 2m
        vm = v.reshape(-1, r, m)
        vm = jnp.transpose(vm, (2, 1, 0))
        return jnp.concatenate([vm, vm], axis=0)

    X = lift(x)
    Y = lift(y)
    for groups in fwd:
        X = _fwd_level(X, groups, r, A)
        Y = _fwd_level(Y, groups, r, A)
    if base == "karatsuba" and r % 2 == 0:
        Z = _base_negacyclic_karatsuba(X, Y, r, A)
    else:
        Z = _base_negacyclic(X, Y, r, A)
    for groups in inv:
        Z = _inv_level(Z, groups, r, A)
    P = Z[:m]                           # Z_i
    Q = Z[m:]                           # Z_{m+i}
    # z[m*j + i] = P[i, j] + Q[i, j-1], with Q[i, -1] wrapping negacyclically
    zm = jnp.concatenate([A.sub(P[:, :1], Q[:, r - 1:]),
                          A.add(P[:, 1:], Q[:, :r - 1])], axis=1)
    zm = A.scale_pow2_inv(zm, logm + 1)   # the deferred inverse halvings
    return jnp.transpose(zm, (2, 1, 0)).reshape(*batch, n)


def nussbaumer_negacyclic_ring(x, y, base: str = "karatsuba"):
    """Negacyclic product of uint32 vectors over Z_{2^32-1}.

    x, y: (..., n) uint32 ring representatives; returns (..., n) normalized
    representatives of (x * y mod (X^n + 1)) mod (2^32 - 1)."""
    return ring_normalize(_nussbaumer(x, y, _RING_ARITH, base))


def nussbaumer_negacyclic_modq(x, y, ps, base: str = "karatsuba"):
    """Negacyclic product over Z_q via the Nussbaumer recursion — exact for
    ALL canonical operands (no coefficient-magnitude restriction): every
    butterfly and base product is carried out mod q.  The reference's
    Z_{2^32-1} path (NTT.cu:147-277) is wrong-silent outside its domain;
    this variant removes the domain entirely."""
    A = _modq_arith(ps.q, ps.r32, ps.r32_shoup, ps.one_shoup)
    return _nussbaumer(x, y, A, base)


def ring_exact_coeff_bound(n: int) -> int:
    """Largest operand-coefficient magnitude C such that the Z_{2^32-1}
    ring path is provably exact: every true product coefficient is a sum of
    exactly n terms +-x_i*y_j, so |z_k| <= n*C^2 must stay <= RING_MOD//2
    for the signed recovery to be unambiguous."""
    import math
    return math.isqrt((RING_MOD // 2) // n)


# Batch chunk for the jitted pipelines: the tensorized recursion's
# intermediates ((2m, r, B) planes through log2(m) butterfly levels plus
# the r-term base-product accumulation) grow ~linearly with batch, so a
# single-shot batch of thousands at n=1024 needs gigabytes of temporaries.
# Shapes are static under jit, so large batches run as a
# sequential lax.map over fixed-size chunks — same results, bounded
# footprint, any batch size.
_BATCH_CHUNK = 512


def _chunked_pairs(body, x, y, chunk: int = _BATCH_CHUNK):
    """Apply body((C, n), (C, n)) -> (C, n) over an arbitrary-leading-shape
    pair, sequentially in chunks of `chunk` rows."""
    shape = x.shape
    n = shape[-1]
    xf = x.reshape(-1, n)
    yf = y.reshape(-1, n)
    B = xf.shape[0]
    if B <= chunk:
        return body(xf, yf).reshape(shape)
    k = B // chunk
    bulk = jax.lax.map(
        lambda ab: body(ab[0], ab[1]),
        (xf[:k * chunk].reshape(k, chunk, n),
         yf[:k * chunk].reshape(k, chunk, n)))
    parts = [bulk.reshape(k * chunk, n)]
    if B % chunk:
        parts.append(body(xf[k * chunk:], yf[k * chunk:]))
    return jnp.concatenate(parts).reshape(shape)


@functools.lru_cache(maxsize=None)
def polymul_nussbaumer_fn(name: str, max_coeff: int | None = None):
    """Jitted negacyclic polymul mod q via the Nussbaumer Z_{2^32-1} ring
    path (the reference's exact-integer formulation, NTT.cu:147-277).

    Ring representatives are mapped to signed integers (reps > 2^31 are
    negative) and reduced mod q — exact only while the true product
    coefficients stay <= 2^31 in magnitude.  `max_coeff` declares the
    caller's operand bound (None means full-range canonical residues, q-1);
    a declared bound outside the provable domain raises instead of
    returning silently wrong results.  For unrestricted operands use
    polymul_nussbaumer_q_fn (exact mod-q recursion)."""
    from ..params import get_params
    ps = get_params(name)
    q = ps.q
    mc = q - 1 if max_coeff is None else int(max_coeff)
    limit = ring_exact_coeff_bound(ps.n)
    if mc > limit:
        raise ValueError(
            f"nussbaumer ring path is exact only for operand coefficients "
            f"<= {limit} at n={ps.n} (declared max_coeff={mc}); pass "
            f"max_coeff<={limit} for small/sparse operands, or use "
            f"algo='nussbaumer' (the exact mod-q recursion, "
            f"polymul_nussbaumer_q_fn) for full-range operands")
    m_mod_q = RING_MOD % q
    half = jnp.uint32(RING_MOD // 2)

    def one(x, y):
        z = nussbaumer_negacyclic_ring(x, y)
        pos = reduce_u32(z, q, ps.one_shoup)
        neg = jnp.where(pos >= u32(m_mod_q), pos - u32(m_mod_q),
                        pos + u32(q - m_mod_q))
        return jnp.where(z > half, neg, pos)

    return jax.jit(lambda x, y: _chunked_pairs(one, u32(x), u32(y)))


@functools.lru_cache(maxsize=None)
def polymul_nussbaumer_q_fn(name: str, base: str = "karatsuba"):
    """Jitted negacyclic polymul via the exact mod-q Nussbaumer recursion —
    valid for ALL canonical operands (no domain restriction, unlike the
    reference's Z_{2^32-1} path and polymul_nussbaumer_fn)."""
    from ..params import get_params
    ps = get_params(name)
    return jax.jit(lambda x, y: _chunked_pairs(
        lambda a, b: nussbaumer_negacyclic_modq(a, b, ps, base),
        u32(x), u32(y)))
