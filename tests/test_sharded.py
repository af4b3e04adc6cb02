"""Multi-device sharding tests on the 8-virtual-CPU-device mesh
(SURVEY.md §4: the same shard_map code path as a multi-GPU host, without
one)."""

import numpy as np
import pytest
import jax

from qtesla_ntt.models import polymul_negacyclic
from qtesla_ntt.parallel import (make_mesh, polymul_dp_fn,
                                 polymul_fourstep_sharded_fn,
                                 ntt_fourstep_sharded_fn)
from qtesla_ntt.params import get_params

needs8 = pytest.mark.skipif(len(jax.devices()) < 8,
                            reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def data16():
    ps = get_params("qtesla-iii-speed")
    rng = np.random.default_rng(77)
    x = rng.integers(0, ps.q, (16, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (16, ps.n), dtype=np.uint32)
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    return ps, x, y, want


@needs8
def test_dp_8way_bit_exact(data16):
    ps, x, y, want = data16
    mesh = make_mesh(data=8, model=1)
    z = np.asarray(polymul_dp_fn(ps.name, mesh)(x, y))
    np.testing.assert_array_equal(z, want)


@needs8
@pytest.mark.parametrize("data,model", [
    (2, 4),
    pytest.param(1, 8, marks=pytest.mark.slow),
    pytest.param(4, 2, marks=pytest.mark.slow)])
def test_fourstep_sharded_bit_exact(data16, data, model):
    ps, x, y, want = data16
    mesh = make_mesh(data=data, model=model)
    z = np.asarray(polymul_fourstep_sharded_fn(ps.name, mesh)(x, y))
    np.testing.assert_array_equal(z, want)


@needs8
def test_fourstep_sharded_matches_local_fourstep_spectrum(data16):
    """Sharded forward spectrum == single-device four-step spectrum (same
    (k1, k2) indexing), catching layout bugs the full-pipeline test could
    mask."""
    from qtesla_ntt.ops import ntt as N
    from qtesla_ntt.ops.tables import get_tables
    import jax.numpy as jnp
    ps, x, y, want = data16
    tbl = get_tables(ps.name)
    mesh = make_mesh(data=2, model=4)
    fwd = ntt_fourstep_sharded_fn(ps.name, mesh)
    X3 = np.asarray(fwd(x))                       # (B, n1, n2) k1-sharded
    n1 = 1 << (tbl.logn // 2)
    local = jax.jit(lambda v: N.fourstep_ntt(
        N.weight_psi(v, tbl), tbl, n1=n1))(jnp.asarray(x))
    # local fourstep output is flat with k = k2*n1 + k1; sharded keeps
    # (k1, k2) matrix layout
    localm = np.asarray(local).reshape(16, tbl.n // n1, n1)  # (B, k2, k1)
    np.testing.assert_array_equal(X3, np.swapaxes(localm, 1, 2))


@needs8
@pytest.mark.slow
def test_fourstep_sharded_other_param_sets(rng):
    for name, mesh in [("qtesla-i", make_mesh(data=2, model=4)),
                       ("qtesla-p-iii", make_mesh(data=1, model=8))]:
        ps = get_params(name)
        x = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
        y = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
        want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
        z = np.asarray(polymul_fourstep_sharded_fn(name, mesh)(x, y))
        np.testing.assert_array_equal(z, want)


@needs8
@pytest.mark.parametrize("name", ["qtesla-iii-speed", "qtesla-p-iii"])
def test_fourstep_sharded_vs_oracle(rng, name):
    """The four-step SP with jnp locals at real sets on a (data=2,
    model=4) mesh, every row against the schoolbook oracle."""
    from qtesla_ntt.oracle import mismatched_rows
    ps = get_params(name)
    x = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fourstep_sharded_fn(
        name, make_mesh(data=2, model=4))(x, y))
    assert mismatched_rows(x, y, z, ps, range(4)) == []


@needs8
@pytest.mark.slow
def test_fourstep_sharded_explicit_n1(data16):
    """Non-default split: n1=64 (n2=16) still bit-exact (the reference
    hardcodes N1=32, main.cuh:17)."""
    ps, x, y, want = data16
    mesh = make_mesh(data=2, model=4)
    z = np.asarray(polymul_fourstep_sharded_fn(ps.name, mesh, n1=64)(x, y))
    np.testing.assert_array_equal(z, want)


@needs8
def test_mesh_validation():
    with pytest.raises(ValueError, match="needs"):
        make_mesh(data=16, model=1)
    # model axis must divide n1 and n2
    mesh = make_mesh(data=1, model=8)
    with pytest.raises(AssertionError, match="divide"):
        polymul_fourstep_sharded_fn("smallprime", mesh)  # n1=4 < 8


@needs8
def test_pad_batch_wrapper_ragged(data16):
    """The shard_map wrapper used for the Pallas kernel must accept batches
    not divisible by the mesh size (pad up, slice back)."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from qtesla_ntt.models import polymul_fn
    from qtesla_ntt.parallel.sharded import _pad_batch_wrapper

    ps, x, y, want = data16
    mesh = make_mesh(data=4, model=2)
    pspec = P(("data", "model"))
    sm = jax.shard_map(polymul_fn(ps.name, "merged"), mesh=mesh,
                       in_specs=(pspec, pspec), out_specs=pspec,
                       check_vma=False)
    fn = jax.jit(_pad_batch_wrapper(sm, mesh.devices.size, nargs=2))
    z = np.asarray(fn(jnp.asarray(x[:5]), jnp.asarray(y[:5])))
    np.testing.assert_array_equal(z, want[:5])


def test_polymul_fixed_dp_merged(rng):
    """DP-sharded fixed-operand products on the virtual CPU mesh (jnp
    path): batch sharded, spectrum replicated."""
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.parallel import make_mesh
    from qtesla_ntt.parallel.sharded import polymul_fixed_dp_fn
    from qtesla_ntt.params import get_params

    ps = get_params("smallprime")
    mesh = make_mesh(data=4, model=2)
    prep, mul = polymul_fixed_dp_fn("smallprime", mesh, algo="merged")
    a = rng.integers(0, ps.q, (ps.n,), dtype=np.uint32)
    x = rng.integers(0, ps.q, (16, ps.n), dtype=np.uint32)
    z = np.asarray(mul(x, prep(a)))
    want = np.asarray(polymul_negacyclic(
        x, np.broadcast_to(a, x.shape), ps, algo="merged"))
    np.testing.assert_array_equal(z, want)


@needs8
def test_fourstep_sharded_roundtrip(data16):
    """Sharded forward + sharded inverse = identity (the inverse transform
    API, symmetric to ntt_fourstep_sharded_fn)."""
    from qtesla_ntt.parallel import intt_fourstep_sharded_fn
    ps, x, _, _ = data16
    mesh = make_mesh(data=2, model=4)
    fwd = ntt_fourstep_sharded_fn(ps.name, mesh)
    inv = intt_fourstep_sharded_fn(ps.name, mesh)
    back = np.asarray(inv(fwd(x)))
    np.testing.assert_array_equal(back, x)