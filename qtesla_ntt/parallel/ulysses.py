"""Ulysses-style sequence parallelism: batch<->position all_to_all
transpose + the UNMODIFIED single-device served pipeline as the local
compute.

SURVEY.md §5 calls the four-step-with-all-to-all "the workload's analog of
Ulysses"; this module is the actual Ulysses transpose.  Within each
model-axis group of k devices, device d holds position chunk d of every
polynomial ((Bl, n/k) coefficient shards, the same memory footprint as the
four-step SP layout).  One polymul:

    1. all_to_all x: split the local batch k ways, concatenate the k
       position chunks -> each device now holds Bl/k FULL (n,) rows.
    2. same for y.
    3. the full single-device pipeline on the (Bl/k, n) rows.
    4. all_to_all z back to position shards.

Cost accounting vs the four-step path (parallel/sharded.py):

  - interconnect bytes: IDENTICAL — 3 all_to_alls of (k-1)/k * local bytes
    per polymul either way (x fwd, y fwd, z back).
  - per-device compute: the served pipeline at batch B/k, vs the
    four-step's strided column/row sub-transforms.
  - requirement: local batch divisible by k (padded up transparently).
    The four-step path remains the only option when B < k (single huge
    polynomial / latency-bound serving) — polymul_sp_fn picks per call.

Reference anchor: NTT.cu:767-802 is the reference's only intra-transform
decomposition (four-step); the reference has no multi-device axis at all
(SURVEY.md §2.4).  The transpose trick only makes sense with a mesh +
collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.tables import get_tables

__all__ = ["polymul_ulysses_fn", "polymul_fixed_ulysses_fn",
           "polymul_sp_fn"]


def _a2a_to_rows(v):
    """(Bl, nloc) position shard -> (Bl/k, n) full rows (batch shard)."""
    return lax.all_to_all(v, "model", split_axis=0, concat_axis=1,
                          tiled=True)


def _a2a_to_positions(v):
    """(Bl/k, n) full rows -> (Bl, nloc) position shard."""
    return lax.all_to_all(v, "model", split_axis=1, concat_axis=0,
                          tiled=True)


def polymul_ulysses_fn(name: str, mesh: Mesh, local: str | None = None):
    """Jitted SP negacyclic polymul: (B, n) x (B, n) -> (B, n), batch over
    'data', positions over 'model' at rest, batch<->position transposed
    around the unmodified single-device pipeline `local` (None: the served
    one, models.served_algo).  Bit-exact vs the single-device pipelines.
    Requires B divisible by data*model (padded up transparently)."""
    from ..models import polymul_fn
    tbl = get_tables(name)
    n = tbl.n
    k = mesh.shape["model"]
    pipeline = polymul_fn(name, local)

    def local_polymul(xl, yl):
        # xl, yl: (Blk, 1, nloc) — the model axis sharded the position dim
        Blk, _, nloc = xl.shape
        xt = _a2a_to_rows(xl.reshape(Blk, nloc))
        yt = _a2a_to_rows(yl.reshape(Blk, nloc))
        zt = pipeline(xt, yt)
        return _a2a_to_positions(zt).reshape(Blk, 1, nloc)

    coeff = P("data", "model", None)

    def polymul(x, y):
        B = x.shape[0]
        x3 = x.reshape(B, k, n // k)
        y3 = y.reshape(B, k, n // k)
        z3 = jax.shard_map(local_polymul, mesh=mesh,
                           in_specs=(coeff, coeff), out_specs=coeff,
                           check_vma=False)(x3, y3)
        return z3.reshape(B, n)

    in_sh = NamedSharding(mesh, P("data", None))
    jfn = jax.jit(polymul, in_shardings=(in_sh, in_sh), out_shardings=in_sh)
    lcm = mesh.shape["data"] * k   # local batch must a2a-split k ways

    def fn(x, y):
        B = x.shape[0]
        pad = (-B) % lcm
        if pad:
            x = jnp.pad(x, ((0, pad), (0, 0)))
            y = jnp.pad(y, ((0, pad), (0, 0)))
        out = jfn(x, y)
        return out[:B] if pad else out

    return fn


def polymul_fixed_ulysses_fn(name: str, mesh: Mesh,
                             local: str | None = None):
    """(prepare, multiply) for SP fixed-operand products under the Ulysses
    layout: prepare(a) computes the full spectrum once (replicated — each
    device runs the full-width fixed kernel on its transposed rows);
    multiply(x, A) costs 2 all_to_alls (x in, z out) + one fwd + one inv
    transform locally."""
    from ..models import polymul_fixed_fn
    tbl = get_tables(name)
    n = tbl.n
    k = mesh.shape["model"]
    prep, mul = polymul_fixed_fn(name, local)

    def local_fixed(xl, A):
        Blk, _, nloc = xl.shape
        xt = _a2a_to_rows(xl.reshape(Blk, nloc))
        zt = mul(xt, A)
        return _a2a_to_positions(zt).reshape(Blk, 1, nloc)

    coeff = P("data", "model", None)

    def fixed_mul(x, A):
        B = x.shape[0]
        x3 = x.reshape(B, k, n // k)
        z3 = jax.shard_map(local_fixed, mesh=mesh,
                           in_specs=(coeff, P()), out_specs=coeff,
                           check_vma=False)(x3, A)
        return z3.reshape(B, n)

    in_sh = NamedSharding(mesh, P("data", None))
    rep = NamedSharding(mesh, P())
    jfn = jax.jit(fixed_mul, in_shardings=(in_sh, rep), out_shardings=in_sh)
    lcm = mesh.shape["data"] * k

    def fn(x, A):
        B = x.shape[0]
        pad = (-B) % lcm
        if pad:
            x = jnp.pad(x, ((0, pad), (0, 0)))
        out = jfn(x, A)
        return out[:B] if pad else out

    def prepare(a):
        return prep(jnp.asarray(a, jnp.uint32).reshape(1, n))[0]

    return prepare, fn


def polymul_sp_fn(name: str, mesh: Mesh, batch_hint: int | None = None,
                  local: str | None = None):
    """Strategy dispatcher for sequence-parallel polymul over the model
    axis: Ulysses (batch<->position transpose + the single-device
    pipeline `local`) whenever the batch supports it, the four-step
    (works down to B=1) otherwise.  `batch_hint`: expected batch per call;
    the Ulysses path needs batch >= data*model to transpose without
    padding waste."""
    k = mesh.shape["model"]
    if k == 1:
        from .sharded import polymul_dp_fn
        return polymul_dp_fn(name, mesh, algo=local)
    lcm = mesh.shape["data"] * k
    if batch_hint is None or batch_hint >= lcm:
        return polymul_ulysses_fn(name, mesh, local=local)
    from .sharded import polymul_fourstep_sharded_fn
    return polymul_fourstep_sharded_fn(name, mesh)
