"""Multi-device sharded negacyclic polymul: batch data-parallelism + four-step
intra-transform sharding with the transpose as an all-to-all.

This is the distributed layer the reference lacks entirely (SURVEY.md §2.4:
single GPU, communication = global memory between kernel launches + PCIe
memcpy).  The four-step N = N1 x N2 decomposition (reference NTT.cu:667-951,
single-kernel, "implicit transpose in the index algebra") becomes the
cross-device axis: column NTTs local -> twiddle -> `lax.all_to_all` reshard
(j2-split -> k1-split) -> row NTTs local.

Layouts (k = model-axis size):
  coefficient domain: (B, n1, n2) with j2 sharded   -> P('data', None, 'model')
  spectral domain:    (B, n1, n2) with k1 sharded   -> P('data', 'model', None)
The pointwise multiply happens in the spectral layout with no reshard, and
the inverse retraces the forward through a second all_to_all back to the
coefficient layout, so one polymul costs exactly 4 all_to_alls (2 operands
forward + ... the product inverse) of (B/d) * n/k elements each.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import ntt as N
from ..ops.modmul import shoup_mulmod
from ..ops.ntt import _subtables
from ..ops.tables import get_tables

__all__ = ["polymul_dp_fn", "polymul_fixed_dp_fn",
           "polymul_fourstep_sharded_fn", "ntt_fourstep_sharded_fn",
           "intt_fourstep_sharded_fn"]


def polymul_dp_fn(name: str, mesh: Mesh, algo: str | None = None):
    """Pure batch data-parallelism: the whole pipeline replicated, batch
    sharded over every mesh device (the reference's one-block-per-polynomial
    batching, scaled across devices); no collectives.  algo None: the
    served pipeline (models.served_algo).

    jnp pipelines go through jit+GSPMD.  The Pallas kernel ('fused') is
    wrapped in shard_map instead: a pallas_call has no SPMD partitioning
    rule, so GSPMD would otherwise all-gather the batch and run it
    replicated — shard_map guarantees each device runs the single-device
    kernel on exactly its local batch shard."""
    from ..models import polymul_fn, served_algo
    if algo is None:
        algo = served_algo(get_tables(name).n)
    pipeline = polymul_fn(name, algo)
    pspec = P(("data", "model"))
    if algo == "fused":
        # check_vma=False: pallas_call outputs carry no varying-mesh-axes
        # annotation.  shard_map needs the global batch divisible by the
        # mesh size; ragged batches are padded up and the output sliced
        # (the jit+GSPMD path below handles ragged batches natively).
        sm = jax.shard_map(pipeline, mesh=mesh, in_specs=(pspec, pspec),
                           out_specs=pspec, check_vma=False)
        return jax.jit(_pad_batch_wrapper(sm, mesh.devices.size, nargs=2))
    spec = NamedSharding(mesh, pspec)
    return jax.jit(pipeline, in_shardings=(spec, spec), out_shardings=spec)


def _pad_batch_wrapper(sharded_fn, nd: int, nargs: int):
    """Pad the leading batch axis of the first `nargs` arguments up to a
    multiple of the device count, run, slice the output back."""
    def fn(*args):
        head, tail = args[:nargs], args[nargs:]
        B = head[0].shape[0]
        pad = (-B) % nd
        if pad:
            head = tuple(jnp.pad(v, ((0, pad),) + ((0, 0),) * (v.ndim - 1))
                         for v in head)
        out = sharded_fn(*head, *tail)
        return out[:B] if pad else out
    return fn


def polymul_fixed_dp_fn(name: str, mesh: Mesh, algo: str | None = None):
    """Data-parallel fixed-operand products: z = x * a for a constant
    polynomial a (the batch-verification serving shape).  Returns
    (prepare, multiply): prepare(a) -> spectrum A (replicated); multiply
    shards the x batch over the whole mesh, A broadcast to every device."""
    from ..models import polymul_fixed_fn, served_algo
    if algo is None:
        algo = served_algo(get_tables(name).n)
    prep, mul = polymul_fixed_fn(name, algo)
    pspec = P(("data", "model"))
    if algo == "fused":
        sm = jax.shard_map(mul, mesh=mesh, in_specs=(pspec, P()),
                           out_specs=pspec, check_vma=False)
        sharded_mul = jax.jit(
            _pad_batch_wrapper(sm, mesh.devices.size, nargs=1))
    else:
        sharded_mul = jax.jit(
            mul,
            in_shardings=(NamedSharding(mesh, pspec),
                          NamedSharding(mesh, P())),
            out_shardings=NamedSharding(mesh, pspec))
    return prep, sharded_mul


@functools.lru_cache(maxsize=None)
def _fourstep_tables(name: str, n1: int):
    """numpy tables shaped (n1, n2) for the sharded pipeline (reuses the
    single-device four-step twiddle construction and the Shoup companions
    already shipped by the tables layer)."""
    from ..ops.ntt import _fourstep_twiddle
    tbl = get_tables(name)
    n2 = tbl.n // n1
    W, W_sh = _fourstep_twiddle(name, n1, inverse=False)
    Winv, Winv_sh = _fourstep_twiddle(name, n1, inverse=True)
    return dict(W=W, W_sh=W_sh, Winv=Winv, Winv_sh=Winv_sh,
                phi=tbl.phi.reshape(n1, n2),
                phi_sh=tbl.phi_shoup.reshape(n1, n2),
                ipsi=tbl.ipsi_pow.reshape(n1, n2),
                ipsi_sh=tbl.ipsi_pow_shoup.reshape(n1, n2))


def _ntt_axis(v, sub, inverse: bool, axis: int):
    """Natural-order cyclic NTT along `axis` via the self-sorting Stockham."""
    v = jnp.swapaxes(v, axis, -1) if axis != -1 else v
    v = N.stockham_inv(v, sub) if inverse else N.stockham_fwd(v, sub)
    return jnp.swapaxes(v, axis, -1) if axis != -1 else v


def ntt_fourstep_sharded_fn(name: str, mesh: Mesh, n1: int | None = None,
                            with_weighting: bool = True):
    """Jitted forward sharded negacyclic-weighted NTT (mainly for tests);
    returns spectral layout (B, n1, n2) with k1 sharded."""
    fwd, _, _, _ = _build(name, mesh, n1, with_weighting)
    return fwd


def intt_fourstep_sharded_fn(name: str, mesh: Mesh, n1: int | None = None,
                             with_weighting: bool = True):
    """Jitted inverse of ntt_fourstep_sharded_fn: spectral (B, n1, n2)
    k1-sharded -> coefficient (B, n) batch-sharded."""
    _, inv, _, _ = _build(name, mesh, n1, with_weighting)
    return inv


def _build(name: str, mesh: Mesh, n1: int | None, with_weighting: bool = True):
    tbl = get_tables(name)
    n, q = tbl.n, tbl.q
    if n1 is None:
        n1 = 1 << (tbl.logn // 2)
    n2 = n // n1
    k = mesh.shape["model"]
    assert n1 % k == 0 and n2 % k == 0, (
        f"model axis {k} must divide both n1={n1} and n2={n2}")
    t1, t2 = _subtables(name, n1), _subtables(name, n2)
    T = _fourstep_tables(name, n1)

    # local forward: (Bl, n1, n2k) j2-sharded -> (Bl, n1/k, n2) k1-sharded
    def fwd_local(xl, phi, phi_sh, W, W_sh):
        if with_weighting:
            xl = shoup_mulmod(xl, phi, phi_sh, q)
        v = _ntt_axis(xl, t1, False, -2)            # j1 -> k1 (local, n1-pt)
        v = shoup_mulmod(v, W, W_sh, q)             # w^(k1*j2)
        v = lax.all_to_all(v, "model", split_axis=1, concat_axis=2,
                           tiled=True)              # j2 gathers, k1 splits
        return _ntt_axis(v, t2, False, -1)          # j2 -> k2 (local, n2-pt)

    # local inverse: spectral (Bl, n1/k, n2) -> coefficient (Bl, n1, n2k)
    def inv_local(zl, Winv, Winv_sh, ipsi, ipsi_sh):
        v = _ntt_axis(zl, t2, True, -1)             # k2 -> j2 (n2-pt inverse)
        v = shoup_mulmod(v, Winv, Winv_sh, q)       # w^(-k1*j2)
        v = lax.all_to_all(v, "model", split_axis=2, concat_axis=1,
                           tiled=True)              # k1 gathers, j2 splits
        v = _ntt_axis(v, t1, True, -2)              # k1 -> j1 (n1-pt inverse)
        if with_weighting:
            v = shoup_mulmod(v, ipsi, ipsi_sh, q)
        return v

    coeff = P("data", None, "model")
    spect = P("data", "model", None)

    def fwd_shmap(x3):
        return jax.shard_map(
            lambda xl, a, b, c, d: fwd_local(xl, a, b, c, d),
            mesh=mesh,
            in_specs=(coeff, P(None, "model"), P(None, "model"),
                      P(None, "model"), P(None, "model")),
            out_specs=spect,
        )(x3, T["phi"], T["phi_sh"], T["W"], T["W_sh"])

    def inv_shmap(z3):
        return jax.shard_map(
            lambda zl, a, b, c, d: inv_local(zl, a, b, c, d),
            mesh=mesh,
            in_specs=(spect, P("model", None), P("model", None),
                      P(None, "model"), P(None, "model")),
            out_specs=coeff,
        )(z3, T["Winv"], T["Winv_sh"], T["ipsi"], T["ipsi_sh"])

    def pointwise(X3, Y3):
        return jax.shard_map(
            lambda a, b: N.pointwise_mul(a, b, tbl),
            mesh=mesh, in_specs=(spect, spect), out_specs=spect,
        )(X3, Y3)

    def polymul(x, y):
        B = x.shape[0]
        x3 = x.reshape(B, n1, n2)
        y3 = y.reshape(B, n1, n2)
        Z = pointwise(fwd_shmap(x3), fwd_shmap(y3))
        return inv_shmap(Z).reshape(B, n)

    in_sh = NamedSharding(mesh, P("data", None))
    fwd_jit = jax.jit(
        lambda x: fwd_shmap(x.reshape(x.shape[0], n1, n2)),
        in_shardings=in_sh)
    inv_jit = jax.jit(
        lambda Z: inv_shmap(Z).reshape(Z.shape[0], n),
        out_shardings=in_sh)
    polymul_jit = jax.jit(polymul, in_shardings=(in_sh, in_sh),
                          out_shardings=in_sh)
    return fwd_jit, inv_jit, polymul_jit, (n1, n2)


def polymul_fourstep_sharded_fn(name: str, mesh: Mesh,
                                n1: int | None = None):
    """Jitted sharded negacyclic polymul: (B, n) x (B, n) -> (B, n), batch
    over 'data', intra-transform over 'model' (four-step + all_to_all), with
    the Stockham jnp pipelines as the local column/row transforms."""
    _, _, polymul_jit, _ = _build(name, mesh, n1)
    return polymul_jit
