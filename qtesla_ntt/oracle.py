"""Exact-integer (object-dtype numpy / Python int) oracles.

Ground truth for every kernel test, mirroring the reference's built-in
self-check strategy (reference: NTT_naive/INTT_naive NTT.cu:515-554 as the
O(N^2) oracle, schoolbook negacyclic base case NTT.cu:147-165, all-ones
closed-form known answer used by the nega benchmarks NTT.cu:1822 ff).

Everything here is deliberately slow and obviously correct: Python ints can't
overflow, so these functions define bit-exactness for the device pipelines.
A native C++ oracle with the same behavior lives in csrc/ (loaded via
qtesla_ntt.utils.native); tests cross-check all three.
"""

from __future__ import annotations

import numpy as np

from .params import ParamSet

__all__ = [
    "ntt_naive",
    "intt_naive",
    "negacyclic_schoolbook",
    "polymul_negacyclic_oracle",
    "all_ones_square_closed_form",
    "ntt_forward_psi_merged",
    "intt_inverse_psi_merged",
    "ring_u32_modmul",
    "ring_u32_modadd",
    "ring_u32_modsub",
    "negacyclic_schoolbook_ring",
    "sample_rows",
    "mismatched_rows",
]


def _as_int_list(x) -> list[int]:
    return [int(v) for v in np.asarray(x).reshape(-1)]


def ntt_naive(x, ps: ParamSet, omega: int | None = None) -> np.ndarray:
    """O(N^2) cyclic NTT: X[k] = sum_j x[j] * w^(jk) mod q  (ref NTT.cu:515-530)."""
    n, q = ps.n, ps.q
    w = ps.omega if omega is None else omega
    xv = _as_int_list(x)
    assert len(xv) == n
    out = np.empty(n, dtype=object)
    for k in range(n):
        acc = 0
        wk = pow(w, k, q)
        pw = 1
        for j in range(n):
            acc = (acc + xv[j] * pw) % q
            pw = (pw * wk) % q
        out[k] = acc
    return out.astype(np.uint64)


def intt_naive(X, ps: ParamSet) -> np.ndarray:
    """O(N^2) inverse cyclic NTT with final x N^{-1} (ref NTT.cu:537-554)."""
    n, q = ps.n, ps.q
    res = ntt_naive(X, ps, omega=ps.omega_inv)
    return ((res.astype(object) * ps.n_inv) % q).astype(np.uint64)


def negacyclic_schoolbook(x, y, ps: ParamSet) -> np.ndarray:
    """z = x*y mod (X^n + 1) mod q by schoolbook double loop."""
    n, q = ps.n, ps.q
    xv, yv = _as_int_list(x), _as_int_list(y)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            p = xv[i] * yv[j]
            if k < n:
                out[k] = (out[k] + p) % q
            else:
                out[k - n] = (out[k - n] - p) % q
    return np.array(out, dtype=np.uint64)


def polymul_negacyclic_oracle(x, y, ps: ParamSet) -> np.ndarray:
    return negacyclic_schoolbook(x, y, ps)


def all_ones_square_closed_form(ps: ParamSet) -> np.ndarray:
    """Negacyclic square of the all-ones polynomial: z[i] = (2i + 2 - n) mod q.

    The reference's known-answer fixture (all-ones operands in every nega
    benchmark, NTT.cu:1822,1862,2010,2099,...)."""
    n, q = ps.n, ps.q
    return np.array([(2 * i + 2 - n) % q for i in range(n)], dtype=np.uint64)


def sample_rows(batch: int, k: int, seed: int = 0) -> np.ndarray:
    """Sorted distinct row indices of a batch: the first, the last and
    random others, k in all (or every row when the batch is smaller)."""
    if batch <= k:
        return np.arange(batch)
    rng = np.random.default_rng(seed)
    mid = rng.choice(np.arange(1, batch - 1), size=k - 2, replace=False)
    return np.sort(np.concatenate([[0, batch - 1], mid]))


def mismatched_rows(x, y, z, ps: ParamSet, rows) -> list[int]:
    """The indices in `rows` where z differs from the schoolbook product of
    x and y.  x, z: (B, n); y: (B, n), or one (n,) fixed operand.  Uses the
    C++ oracle when it builds, else the big-int Python one."""
    from .utils import native
    rows = np.asarray(rows)
    xs = np.asarray(x)[rows]
    y = np.asarray(y)
    ys = np.broadcast_to(y, xs.shape) if y.ndim == 1 else y[rows]
    if native.native_available():
        want = native.negacyclic_schoolbook(xs, ys, ps.q)
    else:
        want = np.stack([negacyclic_schoolbook(a, b, ps)
                         for a, b in zip(xs, ys)]).astype(np.uint32)
    bad = (np.asarray(z)[rows] != want).any(axis=-1)
    return [int(r) for r in rows[bad]]


# ----------------------------------------------------------------------
# Scalar Python-int model of the merged-psi CT forward / GS inverse NTT —
# the exact algorithm the device pipelines vectorize.  Kept here so kernel bugs
# can be bisected against a trivially-readable model.
# ----------------------------------------------------------------------

def ntt_forward_psi_merged(a, ps: ParamSet) -> np.ndarray:
    """Negacyclic forward NTT, psi merged into twiddles.

    Input natural order, output bit-reversed order (the GS->CT reversal-free
    pipeline's forward half; cf. reference GS forward NTT.cu:953-1031 whose
    output is likewise bit-reversed)."""
    n, q = ps.n, ps.q
    tbl = [int(v) for v in ps.psi_rev]
    a = _as_int_list(a)
    t = n
    m = 1
    while m < n:
        t //= 2
        for i in range(m):
            j1 = 2 * i * t
            s = tbl[m + i]
            for j in range(j1, j1 + t):
                u, v = a[j], (a[j + t] * s) % q
                a[j] = (u + v) % q
                a[j + t] = (u - v) % q
        m *= 2
    return np.array(a, dtype=np.uint64)


def intt_inverse_psi_merged(a, ps: ParamSet) -> np.ndarray:
    """Negacyclic inverse NTT, psi^{-1} merged; input bit-reversed, output
    natural, final x n^{-1} applied (folded into the last stage by the
    device pipelines; applied separately here for clarity)."""
    n, q = ps.n, ps.q
    tbl = [int(v) for v in ps.ipsi_rev]
    a = _as_int_list(a)
    t = 1
    m = n
    while m > 1:
        h = m // 2
        j1 = 0
        for i in range(h):
            s = tbl[h + i]
            for j in range(j1, j1 + t):
                u, v = a[j], a[j + t]
                a[j] = (u + v) % q
                a[j + t] = ((u - v) * s) % q
            j1 += 2 * t
        t *= 2
        m = h
    ninv = ps.n_inv
    return np.array([(v * ninv) % q for v in a], dtype=np.uint64)


# ----------------------------------------------------------------------
# Z_{2^32-1} ring scalar model (Nussbaumer arithmetic; ref NTT.cu:102-134).
# ----------------------------------------------------------------------

_M = (1 << 32) - 1


def negacyclic_schoolbook_ring(x, y) -> np.ndarray:
    """Negacyclic product over Z_{2^32-1} (the Nussbaumer path's ring),
    canonical representatives in [0, 2^32-1)."""
    n = len(np.asarray(x).reshape(-1))
    xv, yv = _as_int_list(x), _as_int_list(y)
    out = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            p = xv[i] * yv[j]
            if k < n:
                out[k] = (out[k] + p) % _M
            else:
                out[k - n] = (out[k - n] - p) % _M
    return np.array(out, dtype=np.uint64)


def ring_u32_modadd(a: int, b: int) -> int:
    t = (a + b) % _M
    return t


def ring_u32_modsub(a: int, b: int) -> int:
    return (a - b) % _M


def ring_u32_modmul(a: int, b: int) -> int:
    return (a * b) % _M
