"""Batched NTT transforms in pure jnp/XLA on uint32 lanes.

These run on any backend (XLA fuses the elementwise stage chains); they
also serve as the interpretable reference the fused Pallas kernel
(ntt_pallas.py) is validated against, and they run identically on CPU for
tests.  Every transform operates on the LAST axis of an arbitrarily-batched
array, so `jax.vmap`/`shard_map` compose for free — the successor of the
reference's one-CUDA-block-per-polynomial batching (blockIdx.x indexing
throughout NTT.cu).

Variants (reference parity, SURVEY.md §2.3):
- merged-psi CT forward / GS inverse  — the reversal-free negacyclic pair
  with psi fused into the twiddles; subsumes the reference's GS->CT headline
  pipeline (NTT.cu:2097-2178) plus its separate Phi/invPhi weighting passes.
- cyclic GS (DIF) / CT (DIT) forward+inverse — the reference's radix-2
  kernel families (NTT.cu:953-1056, 1201-1222, 1374-1494) for the
  CT-CT / GS-GS / CT-GS / GS-CT pipeline pairings.
- Stockham autosort forward+inverse — self-sorting, no bit-reversal
  (NTT.cu:1085-1199, 1268-1372).
- dense matrix NTT with precomputed twiddle matrix (NTT.cu:560-659).
- four-step N = N1 x N2 decomposition (NTT.cu:667-951) — also the
  multi-chip SP axis (parallel/fourstep.py).
- bit-reversal permutation (NTT.cu:61-100, 487-509).
- pointwise (Hadamard) modular multiply (NTT.cu:1155-1160).

Conventions: "nat" = natural coefficient order, "rev" = bit-reversed order.
All inputs/outputs are canonical residues in [0, q), dtype uint32.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
from jax import lax

from .modmul import add_mod, mulmod_barrett, shoup_mulmod, sub_mod
from .tables import NttTables

__all__ = [
    "ntt_fwd_merged", "intt_inv_merged",
    "gs_fwd_cyclic", "gs_inv_cyclic", "ct_fwd_cyclic", "ct_inv_cyclic",
    "stockham_fwd", "stockham_inv",
    "matrix_ntt", "fourstep_ntt", "fourstep_intt",
    "bitrev_permute", "pointwise_mul", "weight_psi", "weight_ipsi_ninv",
    "weight_ipsi", "bitrev_weight_ipsi_ninv", "weight_psi_bitrev",
]


# ----------------------------------------------------------------------
# Stage cores: one radix-2 layer over the last axis, any leading batch dims.
# v: (..., n) -> view (..., m, 2, t): m blocks of width 2t.
# ----------------------------------------------------------------------

def _split(v, t: int):
    n = v.shape[-1]
    m = n // (2 * t)
    v = v.reshape(*v.shape[:-1], m, 2, t)
    return v[..., 0, :], v[..., 1, :]


def _merge(a, b):
    out = jnp.stack([a, b], axis=-2)
    return out.reshape(*out.shape[:-3], out.shape[-3] * 2 * out.shape[-1])


def _ct_stage(v, w, wsh, t: int, q: int):
    """DIT butterfly layer: (a, b) -> (a + b*w, a - b*w).
    w broadcastable to (m, t): (m,1) for merged-psi, (1,t) for cyclic."""
    a, b = _split(v, t)
    V = shoup_mulmod(b, w, wsh, q)
    return _merge(add_mod(a, V, q), sub_mod(a, V, q))


def _gs_stage(v, w, wsh, t: int, q: int, w0=None, w0sh=None):
    """DIF butterfly layer: (a, b) -> (a + b, (a - b)*w); optional w0
    multiplies the sum branch too (n^{-1} folding on the last inverse
    stage — the reference instead fuses N^{-1} into invPhi or a final
    kernel tail, NTT.cu:1429-1432)."""
    a, b = _split(v, t)
    s = add_mod(a, b, q)
    d = shoup_mulmod(sub_mod(a, b, q), w, wsh, q)
    if w0 is not None:
        s = shoup_mulmod(s, w0, w0sh, q)
    return _merge(s, d)


# ----------------------------------------------------------------------
# Merged-psi negacyclic pair (flagship; reversal-free end to end).
# ----------------------------------------------------------------------

def ntt_fwd_merged(x, tbl: NttTables):
    """Negacyclic forward NTT, psi merged into twiddles. nat -> rev."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = x
    for s in range(L):
        t = n >> (s + 1)
        w, wsh = tbl.ct_fwd_stages[s]
        v = _ct_stage(v, jnp.asarray(w), jnp.asarray(wsh), t, q)
    return v


def intt_inv_merged(X, tbl: NttTables):
    """Negacyclic inverse NTT, psi^{-1} and n^{-1} merged. rev -> nat."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = X
    for s in range(L):
        t = 1 << s
        w, wsh = tbl.gs_inv_stages[s]
        if t == n // 2:
            w0, w0sh = tbl.ninv_fold
            v = _gs_stage(v, jnp.asarray(w), jnp.asarray(wsh), t, q,
                          jnp.asarray(w0), jnp.asarray(w0sh))
        else:
            v = _gs_stage(v, jnp.asarray(w), jnp.asarray(wsh), t, q)
    return v


# ----------------------------------------------------------------------
# Cyclic radix-2 families (explicit-order; pair with weight_psi /
# weight_ipsi_ninv and bitrev_permute to build all reference pipelines).
# ----------------------------------------------------------------------

def gs_fwd_cyclic(x, tbl: NttTables):
    """Cyclic DIF NTT: nat -> rev (reference GS forward, NTT.cu:1058-1084)."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = x
    for s in range(L):
        h = n >> (s + 1)
        w, wsh = tbl.cyc_fwd[h]
        v = _gs_stage(v, jnp.asarray(w), jnp.asarray(wsh), h, q)
    return v


def gs_inv_cyclic(X, tbl: NttTables, scale_ninv: bool = True):
    """Cyclic DIF with w^{-1}: nat -> rev; optional final n^{-1}."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = X
    for s in range(L):
        h = n >> (s + 1)
        w, wsh = tbl.cyc_inv[h]
        v = _gs_stage(v, jnp.asarray(w), jnp.asarray(wsh), h, q)
    if scale_ninv:
        w0, w0sh = tbl.ninv_fold
        v = shoup_mulmod(v, jnp.asarray(w0[0]), jnp.asarray(w0sh[0]), q)
    return v


def ct_fwd_cyclic(x_rev, tbl: NttTables):
    """Cyclic DIT NTT: rev -> nat (reference CT forward, NTT.cu:1201-1222)."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = x_rev
    for s in range(L):
        h = 1 << s
        w, wsh = tbl.cyc_fwd[h]
        v = _ct_stage(v, jnp.asarray(w), jnp.asarray(wsh), h, q)
    return v


def ct_inv_cyclic(X_rev, tbl: NttTables, scale_ninv: bool = True):
    """Cyclic DIT with w^{-1}: rev -> nat; optional final n^{-1}
    (reference CT inverse, NTT.cu:1374-1494)."""
    q, n, L = tbl.q, tbl.n, tbl.logn
    v = X_rev
    for s in range(L):
        h = 1 << s
        w, wsh = tbl.cyc_inv[h]
        v = _ct_stage(v, jnp.asarray(w), jnp.asarray(wsh), h, q)
    if scale_ninv:
        w0, w0sh = tbl.ninv_fold
        v = shoup_mulmod(v, jnp.asarray(w0[0]), jnp.asarray(w0sh[0]), q)
    return v


# ----------------------------------------------------------------------
# Stockham autosort (self-sorting, out-of-place; nat -> nat).
# Functional ping-pong replaces the reference's d_x/d_X buffer swaps
# (NTT.cu:2040-2049).
# ----------------------------------------------------------------------

def _stockham(x, stages, q: int):
    n = x.shape[-1]
    batch = x.shape[:-1]
    v = x.reshape(*batch, n, 1)           # (..., n_cur, stride)
    for w, wsh in stages:
        nc, stride = v.shape[-2], v.shape[-1]
        m = nc // 2
        a = v[..., :m, :]
        b = v[..., m:, :]
        s = add_mod(a, b, q)
        d = shoup_mulmod(sub_mod(a, b, q), jnp.asarray(w), jnp.asarray(wsh),
                         q)
        v = jnp.stack([s, d], axis=-2).reshape(*batch, m, 2 * stride)
    return v.reshape(*batch, n)


def stockham_fwd(x, tbl: NttTables):
    """Cyclic Stockham NTT, nat -> nat (reference NTT.cu:1085-1153)."""
    return _stockham(x, tbl.stockham_fwd, tbl.q)


def stockham_inv(X, tbl: NttTables, scale_ninv: bool = True):
    v = _stockham(X, tbl.stockham_inv, tbl.q)
    if scale_ninv:
        w0, w0sh = tbl.ninv_fold
        v = shoup_mulmod(v, jnp.asarray(w0[0]), jnp.asarray(w0sh[0]), tbl.q)
    return v


# ----------------------------------------------------------------------
# Dense matrix NTT (precomputed twiddle matrix; reference NTT.cu:560-659).
# O(n^2) work, exact; scanned row-by-row so products stay in uint32 lanes.
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _matrix_tables(name: str, inverse: bool):
    import numpy as np
    from .tables import get_tables
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    tf = tbl.ps.omega_powers(n, inverse=inverse).astype(object)
    idx = (np.outer(np.arange(n), np.arange(n)) % n)
    W = tf[idx].astype(np.uint32)
    Wsh = ((W.astype(object) << 32) // q).astype(np.uint32)
    return W, Wsh


def matrix_ntt(x, tbl: NttTables, inverse: bool = False):
    """X[k] = sum_j x[j] * w^(jk): nat -> nat, via lax.scan over rows of the
    precomputed (n, n) twiddle matrix. Inverse applies n^{-1}."""
    q, n = tbl.q, tbl.n
    W, Wsh = _matrix_tables(tbl.ps.name, inverse)
    Wj = jnp.asarray(W)        # (n_j, n_k)
    Wjsh = jnp.asarray(Wsh)

    def body(acc, inp):
        wrow, wshrow, xj = inp          # (n,), (n,), (batch...,1)
        term = shoup_mulmod(xj, wrow, wshrow, q)
        return add_mod(acc, term, q), None

    xs = jnp.moveaxis(x[..., None], -2, 0)      # (n_j, batch..., 1)
    acc0 = jnp.zeros(x.shape, dtype=jnp.uint32)
    acc, _ = lax.scan(body, acc0, (Wj, Wjsh, xs))
    if inverse:
        w0, w0sh = tbl.ninv_fold
        acc = shoup_mulmod(acc, jnp.asarray(w0[0]), jnp.asarray(w0sh[0]), q)
    return acc


# ----------------------------------------------------------------------
# Four-step N = N1 x N2 (reference NTT.cu:667-951).  nat -> nat.
# The transpose in the index algebra becomes an explicit transpose here
# (and an all_to_all across devices in parallel/sharded.py).
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fourstep_twiddle(name: str, n1: int, inverse: bool):
    import numpy as np
    from .tables import get_tables
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    n2 = n // n1
    tf = tbl.ps.omega_powers(n, inverse=inverse).astype(object)
    idx = (np.outer(np.arange(n1), np.arange(n2)) % n)   # (k1, j2) -> k1*j2
    W = tf[idx].astype(np.uint32)
    Wsh = ((W.astype(object) << 32) // q).astype(np.uint32)
    return W, Wsh


def _small_ntt_last_axis(v, tbl_small: NttTables, inverse: bool):
    """Natural-order cyclic NTT on the last axis via Stockham (self-sorting,
    so no ordering fixups inside the four-step composition)."""
    if inverse:
        return stockham_inv(v, tbl_small)
    return stockham_fwd(v, tbl_small)


@functools.lru_cache(maxsize=None)
def _subtables(name: str, length: int) -> NttTables:
    """A NttTables for the same prime at a shorter transform length (the
    reference's fg1/fg2 sub-transform roots, main.cu:29-48)."""
    from ..params import ParamSet, get_params
    ps = get_params(name)
    sub = ParamSet(name=f"{name}/sub{length}", n=length, q=ps.q)
    return NttTables(sub)


def fourstep_ntt(x, tbl: NttTables, n1: int = 32, inverse: bool = False):
    """Four-step cyclic NTT: columns (n1-point) -> twiddle w^(k1*j2) ->
    rows (n2-point) -> transpose.  nat -> nat.

    Derivation: with j = j1*n2 + j2, k = k2*n1 + k1,
      X[k2*n1 + k1] = NTT_{n2, j2->k2}( w^(j2*k1) * NTT_{n1, j1->k1}(x[j1, j2]) ).
    """
    q, n = tbl.q, tbl.n
    n2 = n // n1
    name = tbl.ps.name
    t1, t2 = _subtables(name, n1), _subtables(name, n2)
    W, Wsh = _fourstep_twiddle(name, n1, inverse)
    batch = x.shape[:-1]
    v = x.reshape(*batch, n1, n2)
    # column NTTs along j1: move axis to last
    v = jnp.swapaxes(v, -1, -2)                     # (..., n2, n1)
    v = _small_ntt_last_axis(v, t1, inverse)        # k1 on last axis
    v = jnp.swapaxes(v, -1, -2)                     # (..., k1, j2)
    v = shoup_mulmod(v, jnp.asarray(W), jnp.asarray(Wsh), q)
    v = _small_ntt_last_axis(v, t2, inverse)        # (..., k1, k2)
    v = jnp.swapaxes(v, -1, -2)                     # (..., k2, k1): k = k2*n1+k1
    # (inverse scaling invariant: each sub-inverse applies its own
    # length^{-1}, and n1^{-1} * n2^{-1} == n^{-1} exactly — no extra factor)
    return v.reshape(*batch, n)


def fourstep_intt(X, tbl: NttTables, n1: int = 32):
    """Inverse four-step; sub-inverses contribute n1^{-1}*n2^{-1} = n^{-1}.

    Note the forward maps j=(j1,j2) -> k=(k2,k1); the inverse of that map is
    the same algorithm with w^{-1} applied to the *transposed* input."""
    n, n2 = tbl.n, tbl.n // n1
    batch = X.shape[:-1]
    # forward output order: X[k2*n1 + k1].  Re-run the same decomposition on
    # the transform domain: treat k index split as k = k2*n1 + k1 -> matrix
    # (n2, n1); the inverse four-step with roles of n1/n2 swapped returns
    # natural j order.
    return fourstep_ntt(X, tbl, n1=n2, inverse=True)


# ----------------------------------------------------------------------
# Permutations, weighting, pointwise.
# ----------------------------------------------------------------------

def bitrev_permute(v, tbl: NttTables):
    """Bit-reversal permutation on the last axis (reference NTT.cu:61-100,
    487-492): one-time static gather."""
    return jnp.take(v, jnp.asarray(tbl.bitrev), axis=-1)


def bitrev_weight_ipsi_ninv(v, tbl: NttTables):
    """Fused bit-reversal x (n^{-1} psi^{-i}) post-weighting — the
    reference's fused invPhi-permute kernel (NTT.cu:494-500) as ONE gather
    + one Shoup multiply: out[i] = v[rev(i)] * n^{-1} * psi^{-i}."""
    return shoup_mulmod(bitrev_permute(v, tbl), jnp.asarray(tbl.inv_phi),
                        jnp.asarray(tbl.inv_phi_shoup), tbl.q)


def weight_psi_bitrev(v, tbl: NttTables):
    """Fused psi-weighting-then-permute — the reference's weight-then-
    __syncthreads-then-permute kernel (NTT.cu:502-509) as ONE gather + one
    Shoup multiply with a pre-permuted weight table:
    out[i] = v[rev(i)] * psi^{rev(i)}."""
    return shoup_mulmod(bitrev_permute(v, tbl),
                        jnp.asarray(tbl.phi[tbl.bitrev]),
                        jnp.asarray(tbl.phi_shoup[tbl.bitrev]), tbl.q)


def weight_psi(v, tbl: NttTables):
    """x[i] * psi^i — explicit negacyclic pre-weighting (reference Phi
    weighting, NTT.cu:502-509, 1828-1832)."""
    return shoup_mulmod(v, jnp.asarray(tbl.phi), jnp.asarray(tbl.phi_shoup),
                        tbl.q)


def weight_ipsi_ninv(v, tbl: NttTables):
    """z[i] * n^{-1} * psi^{-i} — explicit post-weighting (reference invPhi,
    constants.h:19-24, NTT.cu:494-500)."""
    return shoup_mulmod(v, jnp.asarray(tbl.inv_phi),
                        jnp.asarray(tbl.inv_phi_shoup), tbl.q)


def weight_ipsi(v, tbl: NttTables):
    """z[i] * psi^{-i} (no n^{-1} — for inverses that already scaled)."""
    return shoup_mulmod(v, jnp.asarray(tbl.ipsi_pow),
                        jnp.asarray(tbl.ipsi_pow_shoup), tbl.q)


def pointwise_mul(X, Y, tbl: NttTables):
    """Hadamard modular product (reference pointwise_mult, NTT.cu:1155-1160);
    generic Barrett since neither operand is a precomputed constant."""
    ps = tbl.ps
    return mulmod_barrett(X, Y, ps.q, ps.r32, ps.r32_shoup, ps.one_shoup)
