"""Fused negacyclic polymul as one Pallas kernel for the Triton route.

The reference launches one CUDA kernel per butterfly stage with global
memory in between (NTT.cu:2034-2081: 10 launches per transform at n=1024,
plus a pointwise kernel).  Here one program owns a tile of `tile_b` whole
polynomials: it reads x and y once, runs both forward transforms, the
pointwise product and the inverse transform (3*log2(n) stages) on-chip,
and writes z once.  That is the reference's block-per-polynomial mapping
with every stage fused into one launch.

Butterfly data movement: a stage at pair distance t views the (tile_b, n)
tile as (tile_b, m, 2, t), splits the pair axis, and interleaves the two
outputs back with a stack + transpose; Triton keeps those layout changes
in registers and shared memory.

Twiddles: one (4, n) table per parameter set, rows (w, w_shoup) for the
merged-psi CT forward and the merged GS inverse, indexed like the
reference's psi_rev tables (stage with m blocks reads entries [m, 2m)).
Slot 0 of the inverse rows, which no stage reads, holds n^{-1} for the sum
branch of the last inverse stage.

Arithmetic is Harvey-lazy: the forward keeps values in [0, 4q), the
inverse accepts [0, 2q) and ends canonical.  The high word of each 32x32
product is the card's `mul.hi.u32`; interpret mode, which has no inline
assembly, uses the 16-bit-limb form from modmul instead.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .modmul import mulhi32
from .tables import get_tables

__all__ = ["polymul_fused_fn", "polymul_fixed_fused_fn", "fused_tables",
           "tile_rows"]


def _mulhi(x, y, interpret: bool):
    """High word of the 32x32 product.  The inline assembly takes int32:
    Triton's values are signless, and a uint32 result would not mix."""
    if interpret:
        return mulhi32(x, y)
    xi = lax.bitcast_convert_type(x, jnp.int32)
    yi = lax.bitcast_convert_type(jnp.broadcast_to(y, x.shape), jnp.int32)
    [hi] = plgpu.elementwise_inline_asm(
        "mul.hi.u32 $0, $1, $2;", args=[xi, yi], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(x.shape, jnp.int32)])
    return lax.bitcast_convert_type(hi, jnp.uint32)


def _csub(v, bound: int):
    b = np.uint32(bound)
    return jnp.where(v >= b, v - b, v)


def _shoup_lazy(x, w, wsh, q: int, interpret: bool):
    """x*w mod q in [0, 2q) for any uint32 x, w < q precomputed."""
    return x * w - _mulhi(x, wsh, interpret) * np.uint32(q)


def _split_pairs(v, t: int):
    """(R, n) -> a, b of shape (R, m, t): the two halves of each block."""
    R, n = v.shape
    m = n // (2 * t)
    a, b = jnp.split(v.reshape(R, m, 2, t), 2, axis=2)
    return a.reshape(R, m, t), b.reshape(R, m, t)


def _join_pairs(a, b):
    """Inverse of _split_pairs."""
    R, m, t = a.shape
    return jnp.swapaxes(jnp.stack([a, b], axis=-1), -1, -2).reshape(
        R, 2 * m * t)


def _stage_twiddles(tab_ref, row: int, m: int):
    """Entries [m, 2m) of table rows `row` (w) and `row + 1` (w_shoup),
    shaped (1, m, 1) to broadcast over a (R, m, t) half."""
    w = tab_ref[row, pl.ds(m, m)].reshape(1, m, 1)
    wsh = tab_ref[row + 1, pl.ds(m, m)].reshape(1, m, 1)
    return w, wsh


def _forward(v, tab_ref, n: int, q: int, interpret: bool):
    """Merged-psi CT forward, nat -> rev.  Any uint32 < 4q in, [0, 4q) out."""
    L = n.bit_length() - 1
    for s in range(L):
        m, t = 1 << s, n >> (s + 1)
        a, b = _split_pairs(v, t)
        w, wsh = _stage_twiddles(tab_ref, 0, m)
        V = _shoup_lazy(b, w, wsh, q, interpret)             # [0, 2q)
        a = _csub(a, 2 * q)                                  # [0, 2q)
        v = _join_pairs(a + V, a - V + np.uint32(2 * q))     # [0, 4q)
    return v


def _inverse(v, tab_ref, n: int, q: int, interpret: bool):
    """Merged-psi GS inverse with n^{-1} folded, rev -> nat.
    [0, 2q) in, canonical [0, q) out."""
    L = n.bit_length() - 1
    for s in range(L):
        h, t = n >> (s + 1), 1 << s
        a, b = _split_pairs(v, t)
        w, wsh = _stage_twiddles(tab_ref, 2, h)
        d = a - b + np.uint32(2 * q)                         # (0, 4q)
        D = _shoup_lazy(d, w, wsh, q, interpret)             # [0, 2q)
        if h > 1:
            v = _join_pairs(_csub(a + b, 2 * q), D)
        else:
            # last stage: the sum branch takes n^{-1} from slot 0
            w0 = tab_ref[2, pl.ds(0, 1)].reshape(1, 1, 1)
            w0sh = tab_ref[3, pl.ds(0, 1)].reshape(1, 1, 1)
            S = _shoup_lazy(a + b, w0, w0sh, q, interpret)
            v = _join_pairs(_csub(S, q), _csub(D, q))
    return v


def _pointwise(X, Y, q: int, r32: int, r32_sh: int, one_sh: int,
               interpret: bool):
    """X*Y mod q for any uint32 X, Y: fold hi*2^32 + lo with two Shoup
    products (by 2^32 mod q and by 1).  [0, 2q) out."""
    hi = _mulhi(X, Y, interpret)
    lo = X * Y
    a = _shoup_lazy(hi, np.uint32(r32), np.uint32(r32_sh), q, interpret)
    b = _shoup_lazy(lo, np.uint32(1), np.uint32(one_sh), q, interpret)
    return _csub(a + b, 2 * q)


def _polymul_kernel(x_ref, y_ref, tab_ref, z_ref, *, n, q, consts,
                    interpret):
    X = _forward(x_ref[...], tab_ref, n, q, interpret)
    Y = _forward(y_ref[...], tab_ref, n, q, interpret)
    Z = _pointwise(X, Y, q, *consts, interpret)
    z_ref[...] = _inverse(Z, tab_ref, n, q, interpret)


def _polymul_fixed_kernel(x_ref, a_ref, tab_ref, z_ref, *, n, q, consts,
                          interpret):
    X = _forward(x_ref[...], tab_ref, n, q, interpret)
    Z = _pointwise(X, a_ref[...], q, *consts, interpret)
    z_ref[...] = _inverse(Z, tab_ref, n, q, interpret)


@functools.lru_cache(maxsize=None)
def fused_tables(name: str) -> np.ndarray:
    """(4, n) uint32: forward w, forward w_shoup, inverse w, inverse
    w_shoup, in psi_rev indexing (see the module docstring)."""
    tbl = get_tables(name)
    n = tbl.n
    out = np.zeros((4, n), dtype=np.uint32)
    for s, (w, wsh) in enumerate(tbl.ct_fwd_stages):
        m = 1 << s
        out[0, m:2 * m], out[1, m:2 * m] = w.ravel(), wsh.ravel()
    for s, (w, wsh) in enumerate(tbl.gs_inv_stages):
        h = n >> (s + 1)
        out[2, h:2 * h], out[3, h:2 * h] = w.ravel(), wsh.ravel()
    (w0,), (w0sh,) = tbl.ninv_fold
    out[2, 0], out[3, 0] = w0[0], w0sh[0]
    return out


# Warps per program: 4 measured faster than 8 at n=1024 on an H100 (PERF.md).
_NUM_WARPS = 4


def tile_rows(n: int, batch: int, tile_b: int | None = None) -> int:
    """Polynomials per program: `tile_b` if given, else enough to give
    each program at least 1024 coefficients (one polynomial at n=1024, the
    fastest of 1, 2 and 4 on an H100), never more than the batch rounded
    up to a power of two."""
    if tile_b is None:
        tile_b = max(1, 1024 // n)
    return min(tile_b, 1 << max(0, (batch - 1).bit_length()))


def _runner(kernel, name: str, num_batched: int, tile_b: int | None,
            interpret: bool):
    """Wrap `kernel` over any leading batch shape: the first `num_batched`
    arguments are (..., n) batches, the rest are one (n,) row each,
    broadcast to every program.  Pads the batch to a tile multiple."""
    tbl = get_tables(name)
    n = tbl.n
    tab = jnp.asarray(fused_tables(name))

    def run(*args):
        batched = [jnp.asarray(a, jnp.uint32) for a in args[:num_batched]]
        rows = [jnp.asarray(a, jnp.uint32).reshape(1, n)
                for a in args[num_batched:]]
        shape = batched[0].shape
        if shape[-1] != n:
            raise ValueError(f"last axis must be n={n}; got {shape}")
        batched = [a.reshape(-1, n) for a in batched]
        B = batched[0].shape[0]
        tile = tile_rows(n, B, tile_b)
        pad = (-B) % tile
        if pad:
            batched = [jnp.pad(a, ((0, pad), (0, 0))) for a in batched]
        tile_spec = pl.BlockSpec((tile, n), lambda i: (i, 0))
        row_spec = pl.BlockSpec((1, n), lambda i: (0, 0))
        out = pl.pallas_call(
            kernel,
            grid=((B + pad) // tile,),
            in_specs=([tile_spec] * num_batched + [row_spec] * len(rows)
                      + [pl.BlockSpec((4, n), lambda i: (0, 0))]),
            out_specs=tile_spec,
            out_shape=jax.ShapeDtypeStruct((B + pad, n), jnp.uint32),
            backend="triton",
            compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                                 num_stages=1),
            interpret=interpret,
            name="polymul_fused",
        )(*batched, *rows, tab)
        return (out[:B] if pad else out).reshape(shape)

    return run


def _kernel_params(name: str, kernel, interpret: bool):
    tbl = get_tables(name)
    ps = tbl.ps
    return functools.partial(
        kernel, n=tbl.n, q=tbl.q,
        consts=(ps.r32, ps.r32_shoup, ps.one_shoup), interpret=interpret)


@functools.lru_cache(maxsize=None)
def polymul_fused_fn(name: str, tile_b: int | None = None,
                     interpret: bool = False):
    """Jitted fused polymul: (..., n) x (..., n) -> (..., n), canonical."""
    return jax.jit(_runner(_kernel_params(name, _polymul_kernel, interpret),
                           name, 2, tile_b, interpret))


@functools.lru_cache(maxsize=None)
def polymul_fixed_fused_fn(name: str, tile_b: int | None = None,
                           interpret: bool = False):
    """Jitted fixed-operand fused polymul: (..., n) x spectrum (n,) ->
    (..., n).  The spectrum is the merged-psi forward NTT of the constant
    operand (ops.ntt.ntt_fwd_merged), any representative mod q."""
    return jax.jit(_runner(
        _kernel_params(name, _polymul_fixed_kernel, interpret),
        name, 1, tile_b, interpret))
