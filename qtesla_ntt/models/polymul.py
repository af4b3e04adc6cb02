"""Negacyclic polynomial-multiplication pipelines (the framework's "model
families").

Each algorithm is a full pipeline z = x * y mod (X^n + 1) mod q, batched over
leading axes, assembled from the ops layer — the successor of the
reference's test_NTT_*_nega_gpu pipelines (NTT.cu:2008-2443: Stockham,
GS-CT, CT-CT, GS-GS, CT-GS) plus the merged-psi pipeline and the
Nussbaumer / naive-oracle alternatives.

The reference pays ~20 kernel launches + PCIe per polymul; here each pipeline
is a single jitted XLA program, and `fused` is a single Pallas kernel for
the GPU (ops/ntt_pallas.py).  `served_algo` is the one place that decides
which of them serves a shape on the device at hand.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..ops import ntt as N
from ..ops.tables import NttTables, get_tables
from ..params import ParamSet


def _tables(ps) -> NttTables:
    if isinstance(ps, str):
        return get_tables(ps)
    if isinstance(ps, ParamSet):
        return get_tables(ps.name)
    if isinstance(ps, NttTables):
        return ps
    raise TypeError(f"expected param-set name/ParamSet/NttTables, got {ps!r}")


# ----------------------------------------------------------------------
# Public transform API (flagship merged-psi pair).
# ----------------------------------------------------------------------

def ntt(x, ps, algo: str = "merged"):
    """Forward negacyclic NTT. 'merged': nat -> rev, psi in twiddles."""
    tbl = _tables(ps)
    if algo == "merged":
        return N.ntt_fwd_merged(x, tbl)
    if algo == "stockham":
        return N.stockham_fwd(N.weight_psi(x, tbl), tbl)
    raise ValueError(f"unknown ntt algo {algo!r}")


def intt(X, ps, algo: str = "merged"):
    """Inverse negacyclic NTT (matching `ntt`'s output order)."""
    tbl = _tables(ps)
    if algo == "merged":
        return N.intt_inv_merged(X, tbl)
    if algo == "stockham":
        return N.weight_ipsi_ninv(N.stockham_inv(X, tbl, scale_ninv=False),
                                  tbl)
    raise ValueError(f"unknown intt algo {algo!r}")


# ----------------------------------------------------------------------
# Pipelines.  All: (B..., n) x (B..., n) -> (B..., n), canonical residues.
# ----------------------------------------------------------------------

def _pm_merged(x, y, tbl):
    """Flagship: merged-psi CT fwd + GS inv; reversal-free, no separate
    weighting passes (strictly fewer ops than the reference's headline
    GS->CT pipeline, NTT.cu:2097-2178)."""
    X = N.ntt_fwd_merged(x, tbl)
    Y = N.ntt_fwd_merged(y, tbl)
    return N.intt_inv_merged(N.pointwise_mul(X, Y, tbl), tbl)


def _pm_gs_ct(x, y, tbl):
    """Reference headline pairing (NTT.cu:2097-2178): cyclic GS (DIF) fwd
    [nat->rev] + cyclic CT (DIT) inv [rev->nat] — bit-reversals cancel;
    explicit psi weighting around the cyclic transforms."""
    X = N.gs_fwd_cyclic(N.weight_psi(x, tbl), tbl)
    Y = N.gs_fwd_cyclic(N.weight_psi(y, tbl), tbl)
    Z = N.pointwise_mul(X, Y, tbl)
    return N.weight_ipsi_ninv(N.ct_inv_cyclic(Z, tbl, scale_ninv=False), tbl)


def _pm_ct_ct(x, y, tbl):
    """CT fwd + CT inv (reference NTT.cu:2181-2268): DIT needs rev input,
    so both directions pay an explicit bit-reversal gather."""
    X = N.ct_fwd_cyclic(N.bitrev_permute(N.weight_psi(x, tbl), tbl), tbl)
    Y = N.ct_fwd_cyclic(N.bitrev_permute(N.weight_psi(y, tbl), tbl), tbl)
    Z = N.bitrev_permute(N.pointwise_mul(X, Y, tbl), tbl)
    return N.weight_ipsi_ninv(N.ct_inv_cyclic(Z, tbl, scale_ninv=False), tbl)


def _pm_gs_gs(x, y, tbl):
    """GS fwd + GS inv (reference NTT.cu:2271-2356): DIF outputs rev and
    consumes nat, so the spectral domain pays one bit-reversal."""
    X = N.gs_fwd_cyclic(N.weight_psi(x, tbl), tbl)
    Y = N.gs_fwd_cyclic(N.weight_psi(y, tbl), tbl)
    Z = N.bitrev_permute(N.pointwise_mul(X, Y, tbl), tbl)
    z = N.bitrev_permute(N.gs_inv_cyclic(Z, tbl, scale_ninv=False), tbl)
    return N.weight_ipsi_ninv(z, tbl)


def _pm_ct_gs(x, y, tbl):
    """CT fwd + GS inv (reference NTT.cu:2358-2443)."""
    X = N.ct_fwd_cyclic(N.bitrev_permute(N.weight_psi(x, tbl), tbl), tbl)
    Y = N.ct_fwd_cyclic(N.bitrev_permute(N.weight_psi(y, tbl), tbl), tbl)
    Z = N.pointwise_mul(X, Y, tbl)                       # natural order
    z = N.bitrev_permute(N.gs_inv_cyclic(Z, tbl, scale_ninv=False), tbl)
    return N.weight_ipsi_ninv(z, tbl)


def _pm_stockham(x, y, tbl):
    """Stockham fwd/inv (reference NTT.cu:2008-2094): self-sorting, no
    bit-reversal anywhere; psi weighting fused by XLA into the stage chain
    (the reference fuses it into the first/last kernels, NTT.cu:1099-1101,
    1335-1336)."""
    X = N.stockham_fwd(N.weight_psi(x, tbl), tbl)
    Y = N.stockham_fwd(N.weight_psi(y, tbl), tbl)
    Z = N.pointwise_mul(X, Y, tbl)
    return N.weight_ipsi_ninv(N.stockham_inv(Z, tbl, scale_ninv=False), tbl)


def _pm_fourstep(x, y, tbl, n1: int | None = None):
    """Four-step N=N1xN2 pipeline (reference NTT.cu:667-951) — the
    decomposition that becomes the multi-chip SP axis (parallel/)."""
    if n1 is None:
        n1 = 1 << (tbl.logn // 2)   # balanced split (reference fixes N1=32)
    X = N.fourstep_ntt(N.weight_psi(x, tbl), tbl, n1=n1)
    Y = N.fourstep_ntt(N.weight_psi(y, tbl), tbl, n1=n1)
    Z = N.pointwise_mul(X, Y, tbl)
    # fourstep_intt's sub-inverses already contribute n^{-1}; weight by
    # psi^{-i} only
    return N.weight_ipsi(N.fourstep_intt(Z, tbl, n1=n1), tbl)


def _pm_matrix(x, y, tbl):
    """Dense precomputed-matrix NTT pipeline (reference NTT.cu:560-659)."""
    X = N.matrix_ntt(N.weight_psi(x, tbl), tbl)
    Y = N.matrix_ntt(N.weight_psi(y, tbl), tbl)
    Z = N.pointwise_mul(X, Y, tbl)
    # matrix_ntt(inverse=True) already applies n^{-1}
    return N.weight_ipsi(N.matrix_ntt(Z, tbl, inverse=True), tbl)


ALGORITHMS: dict[str, Callable] = {
    "merged": _pm_merged,
    "gs_ct": _pm_gs_ct,
    "ct_ct": _pm_ct_ct,
    "gs_gs": _pm_gs_gs,
    "ct_gs": _pm_ct_gs,
    "stockham": _pm_stockham,
    "four_step": _pm_fourstep,
    "matrix": _pm_matrix,
}


# Lengths n at which the fused kernel beat `merged` end to end on an H100,
# with two streamed operands and with a fixed one alike (PERF.md, PR 1).
_FUSED_SERVES = frozenset({512, 1024, 2048})


def served_algo(n: int) -> str:
    """The pipeline that serves length-n products, for both operand shapes,
    on this process's default device: the fused kernel on a GPU at the
    lengths where it measured faster, else `merged`."""
    if jax.default_backend() == "gpu" and n in _FUSED_SERVES:
        return "fused"
    return "merged"


def _resolve(name: str, algo: str | None) -> str:
    return served_algo(get_tables(name).n) if algo is None else algo


def polymul_fn(name: str, algo: str | None = None):
    """A jitted (x, y) -> z negacyclic polymul for one param set + algorithm
    (None: `served_algo`).  Tables are closed over and baked into the
    executable as constants."""
    return _polymul_fn(name, _resolve(name, algo))


@functools.lru_cache(maxsize=None)
def _polymul_fn(name: str, algo: str):
    if algo in ALGORITHMS:
        return jax.jit(functools.partial(ALGORITHMS[algo],
                                         tbl=get_tables(name)))
    if algo == "fused":
        from ..ops.ntt_pallas import polymul_fused_fn
        return polymul_fused_fn(name)
    if algo == "nussbaumer":
        # the exact mod-q recursion: valid for ALL operands.  The
        # reference-shaped Z_{2^32-1} ring path (domain-restricted,
        # guarded) stays available as ops.nussbaumer.
        # polymul_nussbaumer_fn(name, max_coeff=...).
        from ..ops.nussbaumer import polymul_nussbaumer_q_fn
        return polymul_nussbaumer_q_fn(name)
    raise ValueError(
        f"unknown algorithm {algo!r}; available: "
        f"{sorted(ALGORITHMS) + ['fused', 'nussbaumer']}")


def polymul_fixed_fn(name: str, algo: str | None = None):
    """(prepare, multiply) pair for fixed-operand products z = x * a with a
    constant polynomial a (the qTESLA verification shape: a is the public
    polynomial).  prepare(a) -> A, the merged-psi spectrum of a, same shape
    (run once); multiply(x, A) with A of shape (n,) -> (B, n) products,
    costing one forward + one inverse transform each (the
    streamed-both-operands pipelines pay two forwards).  algo: 'merged' or
    'fused' (None: `served_algo`)."""
    return _polymul_fixed_fn(name, _resolve(name, algo))


@functools.lru_cache(maxsize=None)
def _polymul_fixed_fn(name: str, algo: str):
    tbl = get_tables(name)
    prep = jax.jit(functools.partial(N.ntt_fwd_merged, tbl=tbl))
    if algo == "fused":
        from ..ops.ntt_pallas import polymul_fixed_fused_fn
        return prep, polymul_fixed_fused_fn(name)
    if algo == "merged":
        def mul(x, A):
            X = N.ntt_fwd_merged(x, tbl)
            return N.intt_inv_merged(N.pointwise_mul(X, A, tbl), tbl)

        return prep, jax.jit(mul)
    raise ValueError(f"unknown fixed-operand algo {algo!r}")


def polymul_negacyclic(x, y, ps, algo: str | None = None):
    """z = x*y mod (X^n + 1) mod q, batched over leading axes (algo None:
    `served_algo`)."""
    tbl = _tables(ps)
    x = jnp.asarray(x, dtype=jnp.uint32)
    y = jnp.asarray(y, dtype=jnp.uint32)
    if x.shape[-1] != tbl.n or y.shape[-1] != tbl.n:
        raise ValueError(
            f"last axis must be n={tbl.n} for {tbl.ps.name}; got "
            f"x{x.shape}, y{y.shape}")
    return polymul_fn(tbl.ps.name, algo)(x, y)
