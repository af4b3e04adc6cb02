"""Fused Pallas kernel tests.  On the CPU the kernel runs in interpret mode
(the same kernel body, with the 16-bit-limb high-word multiply in place of
the card's inline `mul.hi.u32`); the `gpu` cases run the compiled kernel
and skip without a card.  Every comparison is bit for bit."""

import numpy as np
import pytest
import jax.numpy as jnp

from qtesla_ntt.models import polymul_fixed_fn, polymul_fn, polymul_negacyclic
from qtesla_ntt.ops import ntt as N
from qtesla_ntt.ops.ntt_pallas import (fused_tables, polymul_fixed_fused_fn,
                                       polymul_fused_fn, tile_rows)
from qtesla_ntt.ops.tables import get_tables
from qtesla_ntt.params import get_params

SETS = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i",
        "qtesla-p-iii"]
REAL_SETS = SETS[1:]


def _spectrum(name, a):
    return N.ntt_fwd_merged(jnp.asarray(a, jnp.uint32), get_tables(name))


@pytest.mark.parametrize("name", SETS)
def test_fused_polymul_bit_exact(rng, name):
    ps = get_params(name)
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fused_fn(name, interpret=True)(x, y))
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(z, want)


@pytest.mark.parametrize("name", SETS)
def test_fused_fixed_operand_bit_exact(rng, name):
    """Fixed-operand kernel (one fwd + pointwise against a broadcast
    spectrum + inverse) vs the streamed two-operand pipeline."""
    ps = get_params(name)
    a = rng.integers(0, ps.q, (ps.n,), dtype=np.uint32)
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fixed_fused_fn(name, interpret=True)(
        x, _spectrum(name, a)))
    want = np.asarray(polymul_negacyclic(
        x, np.broadcast_to(a, x.shape), ps, algo="merged"))
    np.testing.assert_array_equal(z, want)


@pytest.mark.parametrize("shape", [(7,), (2, 3), (1,)])
def test_fused_batch_padding(rng, shape):
    """Batches that don't divide the tile are padded and sliced; leading
    axes are flattened and restored."""
    ps = get_params("smallprime")
    x = rng.integers(0, ps.q, (*shape, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (*shape, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fused_fn("smallprime", tile_b=4,
                                    interpret=True)(x, y))
    assert z.shape == x.shape
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(z, want)


@pytest.mark.parametrize("tile_b", [1, 2])
def test_fused_tile_sizes(rng, tile_b):
    ps = get_params("qtesla-i")
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fused_fn("qtesla-i", tile_b=tile_b,
                                    interpret=True)(x, y))
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(z, want)


def test_fused_rejects_wrong_length():
    x = np.zeros((2, 16), np.uint32)
    with pytest.raises(ValueError, match="last axis"):
        polymul_fused_fn("smallprime", interpret=True)(x, x)


@pytest.mark.parametrize("n,batch,tile_b,want", [
    (1024, 32768, None, 1),     # one polynomial per program at n=1024
    (512, 32768, None, 2),
    (2048, 32768, None, 1),
    (64, 32768, None, 16),
    (64, 3, None, 4),           # never more than the batch's power of two
    (64, 1, None, 1),
    (1024, 5, 4, 4),
])
def test_tile_rows(n, batch, tile_b, want):
    assert tile_rows(n, batch, tile_b) == want


@pytest.mark.parametrize("name", ["smallprime", "qtesla-iii-speed"])
def test_fused_tables_layout(name):
    """Stage s of the forward reads entries [m, 2m) with m = 2^s; the
    inverse stage with h blocks reads [h, 2h); slot 0 of the inverse rows
    is n^{-1}."""
    tbl = get_tables(name)
    t = fused_tables(name)
    assert t.shape == (4, tbl.n) and t.dtype == np.uint32
    for s, (w, wsh) in enumerate(tbl.ct_fwd_stages):
        m = 1 << s
        np.testing.assert_array_equal(t[0, m:2 * m], w.ravel())
        np.testing.assert_array_equal(t[1, m:2 * m], wsh.ravel())
    for s, (w, wsh) in enumerate(tbl.gs_inv_stages):
        h = tbl.n >> (s + 1)
        np.testing.assert_array_equal(t[2, h:2 * h], w.ravel())
        np.testing.assert_array_equal(t[3, h:2 * h], wsh.ravel())
    assert t[2, 0] == tbl.ps.n_inv


def test_fused_via_models_api():
    """algo='fused' reaches the kernel through the public model API."""
    assert polymul_fn("smallprime", "fused") is polymul_fused_fn("smallprime")
    assert (polymul_fixed_fn("smallprime", "fused")[1]
            is polymul_fixed_fused_fn("smallprime"))


@pytest.mark.gpu
@pytest.mark.parametrize("name", REAL_SETS)
def test_fused_compiled_matches_merged(gpu, rng, name):
    """The compiled kernel (inline mul.hi.u32) against `merged`, both
    operand shapes; chip_smoke.py phase (d) runs the same check at full
    batch."""
    ps = get_params(name)
    x = rng.integers(0, ps.q, (257, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (257, ps.n), dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(polymul_fused_fn(name)(x, y)),
        np.asarray(polymul_negacyclic(x, y, ps, algo="merged")))
    A = _spectrum(name, y[0])
    np.testing.assert_array_equal(
        np.asarray(polymul_fixed_fused_fn(name)(x, A)),
        np.asarray(polymul_fixed_fn(name, "merged")[1](x, A)))
