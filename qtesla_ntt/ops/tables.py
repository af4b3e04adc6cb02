"""Per-parameter-set kernel table bundles (numpy uint32), built once and
cached.  These are the successors of the reference's __constant__
GPU tables (constants.h:3-35: bitrev_tbl_gpu, Phi_gpu, invPhi_gpu, tf0_gpu,
ti0_gpu) and the runtime twiddle precompute (main.cu:118-146) — generated
with exact Python ints, in the shapes the vectorized stage kernels consume:

- merged-psi CT-forward / GS-inverse per-stage tables, twiddle constant per
  *block* (shape (m, 1)), with n^{-1} folded into the last inverse stage;
- cyclic DIF/DIT per-stage tables, twiddle varying *within* a block
  (shape (1, h));
- Stockham per-stage tables;
- psi / psi^{-1}*n^{-1} weighting vectors (the reference's Phi / invPhi);
- every table shipped with its Shoup companion.
"""

from __future__ import annotations

import functools

import numpy as np

from ..params import ParamSet

__all__ = ["NttTables", "get_tables"]


def _shoup_arr(tbl: np.ndarray, q: int) -> np.ndarray:
    return ((tbl.astype(object) << 32) // q).astype(np.uint32)


class NttTables:
    """All device tables for one parameter set. Fields are numpy uint32."""

    def __init__(self, ps: ParamSet):
        self.ps = ps
        n, q, L = ps.n, ps.q, ps.logn
        self.n, self.q, self.logn = n, q, L
        psi_rev = ps.psi_rev.astype(object)
        ipsi_rev = ps.ipsi_rev.astype(object)

        # ---- merged-psi CT forward: stage s has m=2^s blocks of width 2t,
        # block i uses psi_rev[m+i]; shape (m, 1) to broadcast within block.
        self.ct_fwd_stages = []
        for s in range(L):
            m = 1 << s
            w = psi_rev[m:2 * m].astype(np.uint32).reshape(m, 1)
            self.ct_fwd_stages.append((w, _shoup_arr(w, q)))

        # ---- merged-psi GS inverse: stage with h blocks uses ipsi_rev[h+i];
        # n^{-1} folded into the LAST stage (h=1): the sum branch gets n^{-1},
        # the diff branch gets ipsi_rev[1]*n^{-1} (the reference instead
        # pre-fuses N^{-1} into its invPhi table, constants.h:19-24).
        self.gs_inv_stages = []
        for s in range(L):
            h = n >> (s + 1)
            w = ipsi_rev[h:2 * h]
            if h == 1:
                w = (w * ps.n_inv) % q
            w = w.astype(np.uint32).reshape(h, 1)
            self.gs_inv_stages.append((w, _shoup_arr(w, q)))
        ninv = np.full((1, 1), ps.n_inv, dtype=np.uint32)
        self.ninv_fold = (ninv, _shoup_arr(ninv, q))

        # ---- cyclic DIF/DIT stage tables: stage with half-width h uses
        # w^(j * n/(2h)) for j in 0..h-1, shape (1, h).
        tf = ps.omega_powers(n).astype(object)
        ti = ps.omega_powers(n, inverse=True).astype(object)

        def cyc(stage_tbl, h):
            stride = n // (2 * h)
            w = stage_tbl[0:h * stride:stride].astype(np.uint32).reshape(1, h)
            return (w, _shoup_arr(w, q))

        self.cyc_fwd = {h: cyc(tf, h) for h in (1 << np.arange(L))}
        self.cyc_inv = {h: cyc(ti, h) for h in (1 << np.arange(L))}

        # ---- Stockham per-stage tables: stage with current length nc uses
        # root of order nc: w^(p * n/nc), p in 0..nc/2-1, shape (nc/2, 1)
        # (twiddle constant across the stride axis).
        self.stockham_fwd = []
        self.stockham_inv = []
        nc = n
        while nc >= 2:
            m = nc // 2
            stride = n // nc
            wf = tf[0:m * stride:stride].astype(np.uint32).reshape(m, 1)
            wi = ti[0:m * stride:stride].astype(np.uint32).reshape(m, 1)
            self.stockham_fwd.append((wf, _shoup_arr(wf, q)))
            self.stockham_inv.append((wi, _shoup_arr(wi, q)))
            nc //= 2

        # ---- negacyclic weighting vectors (reference Phi / invPhi,
        # constants.h:13-27): phi[i] = psi^i; inv_phi[i] = n^{-1} psi^{-i}.
        pw, ipw = 1, ps.n_inv
        phi = np.empty(n, dtype=object)
        inv_phi = np.empty(n, dtype=object)
        for i in range(n):
            phi[i] = pw
            inv_phi[i] = ipw
            pw = (pw * ps.psi) % q
            ipw = (ipw * ps.psi_inv) % q
        self.phi = phi.astype(np.uint32)
        self.phi_shoup = _shoup_arr(self.phi, q)
        self.inv_phi = inv_phi.astype(np.uint32)
        self.inv_phi_shoup = _shoup_arr(self.inv_phi, q)
        # psi^{-i} without the n^{-1} factor (for pipelines whose inverse
        # transform already applied n^{-1}, e.g. four-step)
        ipsi_only = (inv_phi * ps.n) % q
        self.ipsi_pow = ipsi_only.astype(np.uint32)
        self.ipsi_pow_shoup = _shoup_arr(self.ipsi_pow, q)

        self.bitrev = ps.bitrev_tbl.astype(np.int32)


@functools.lru_cache(maxsize=None)
def get_tables(name: str) -> NttTables:
    from ..params import get_params
    return NttTables(get_params(name))
