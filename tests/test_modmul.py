"""Bit-exactness tests for the lane-parallel uint32 modular arithmetic
(qtesla_ntt/ops/modmul.py) against Python big-int ground truth, over the full
operand range — SURVEY.md §7 step 3 ("decides everything downstream")."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from qtesla_ntt.ops import modmul as mm
from qtesla_ntt.params import get_params

QS = [4205569, 8404993, 343576577, 856145921, 65537]


def _rand_u32(rng, lo, hi, size):
    return rng.integers(lo, hi, size=size, dtype=np.uint64).astype(np.uint32)


def test_mulhi32_exhaustive_edges(rng):
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000,
                     0xFFFFFFFE, 0xFFFFFFFF], dtype=np.uint32)
    x = np.repeat(edge, len(edge))
    y = np.tile(edge, len(edge))
    got = np.asarray(jax.jit(mm.mulhi32)(jnp.asarray(x), jnp.asarray(y)))
    want = ((x.astype(object) * y.astype(object)) >> 32).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_mulhi32_random(rng):
    x = _rand_u32(rng, 0, 1 << 32, 4096)
    y = _rand_u32(rng, 0, 1 << 32, 4096)
    got = np.asarray(jax.jit(mm.mulhi32)(jnp.asarray(x), jnp.asarray(y)))
    want = ((x.astype(object) * y.astype(object)) >> 32).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_widemul32(rng):
    x = _rand_u32(rng, 0, 1 << 32, 1024)
    y = _rand_u32(rng, 0, 1 << 32, 1024)
    hi, lo = jax.jit(mm.widemul32)(jnp.asarray(x), jnp.asarray(y))
    prod = x.astype(object) * y.astype(object)
    np.testing.assert_array_equal(np.asarray(hi), (prod >> 32).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), (prod & 0xFFFFFFFF).astype(np.uint32))


@pytest.mark.parametrize("q", QS)
def test_add_sub_mod(rng, q):
    a = _rand_u32(rng, 0, q, 4096)
    b = _rand_u32(rng, 0, q, 4096)
    got_a = np.asarray(jax.jit(mm.add_mod, static_argnums=2)(a, b, q))
    got_s = np.asarray(jax.jit(mm.sub_mod, static_argnums=2)(a, b, q))
    np.testing.assert_array_equal(got_a, ((a.astype(object) + b) % q).astype(np.uint32))
    np.testing.assert_array_equal(got_s, ((a.astype(object) - b) % q).astype(np.uint32))


@pytest.mark.parametrize("q", QS)
def test_shoup_mulmod_full_x_range(rng, q):
    """Shoup mulmod must be exact for ANY uint32 x (lazy-reduction inputs),
    constant w < q."""
    w = _rand_u32(rng, 0, q, 2048)
    wsh = ((w.astype(object) << 32) // q).astype(np.uint32)
    x = _rand_u32(rng, 0, 1 << 32, 2048)
    # include worst-case edges
    x[:4] = [0, 1, 0xFFFFFFFF, q - 1]
    w[:4] = [0, 1, q - 1, q - 1]
    wsh[:4] = ((w[:4].astype(object) << 32) // q).astype(np.uint32)
    got = np.asarray(jax.jit(mm.shoup_mulmod, static_argnums=3)(x, w, wsh, q))
    want = ((x.astype(object) * w.astype(object)) % q).astype(np.uint32)
    np.testing.assert_array_equal(got, want)
    lazy = np.asarray(jax.jit(mm.shoup_mulmod_lazy, static_argnums=3)(x, w, wsh, q))
    assert (lazy.astype(np.uint64) < 2 * q).all()


@pytest.mark.parametrize("q", QS)
def test_reduce_u32(rng, q):
    ps_one_shoup = (1 << 32) // q
    x = _rand_u32(rng, 0, 1 << 32, 4096)
    x[:3] = [0, q, 0xFFFFFFFF]
    got = np.asarray(jax.jit(mm.reduce_u32, static_argnums=(1, 2))(x, q, ps_one_shoup))
    np.testing.assert_array_equal(got, (x.astype(object) % q).astype(np.uint32))


@pytest.mark.parametrize("name", ["qtesla-i", "qtesla-iii-speed",
                                  "qtesla-p-i", "qtesla-p-iii"])
def test_mulmod_barrett_generic(rng, name):
    ps = get_params(name)
    q = ps.q
    x = _rand_u32(rng, 0, q, 4096)
    y = _rand_u32(rng, 0, q, 4096)
    x[:2] = [q - 1, 0]
    y[:2] = [q - 1, q - 1]
    fn = jax.jit(mm.mulmod_barrett, static_argnums=(2, 3, 4, 5))
    got = np.asarray(fn(x, y, q, ps.r32, ps.r32_shoup, ps.one_shoup))
    want = ((x.astype(object) * y.astype(object)) % q).astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q", QS)
def test_shoup_mulmod_sloppy(rng, q):
    """Sloppy variant: congruent mod q and provably < 4q for ANY uint32 x
    (including the adversarial corners that maximize the dropped carry)."""
    w = _rand_u32(rng, 0, q, 4096)
    x = _rand_u32(rng, 0, 1 << 32, 4096)
    x[:4] = [0, 0xFFFFFFFF, 0xFFFF, 0xFFFF0000]
    w[:4] = [q - 1, q - 1, q - 1, q - 1]
    wsh = ((w.astype(object) << 32) // q).astype(np.uint32)
    got = np.asarray(jax.jit(mm.shoup_mulmod_sloppy, static_argnums=3)(
        x, w, wsh, q))
    want = (x.astype(object) * w.astype(object)) % q
    assert (got.astype(np.uint64) < 4 * q).all(), "sloppy bound violated"
    np.testing.assert_array_equal(got.astype(object) % q, want)


def test_mulhi32_sloppy_error_bound(rng):
    """hi_sloppy in {hi-2, hi-1, hi} for all inputs, incl. carry-maximizing
    corners."""
    x = _rand_u32(rng, 0, 1 << 32, 8192)
    y = _rand_u32(rng, 0, 1 << 32, 8192)
    x[:3] = [0xFFFFFFFF, 0xFFFF, 0x0001FFFF]
    y[:3] = [0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF]
    got = np.asarray(jax.jit(mm.mulhi32_sloppy)(x, y)).astype(object)
    exact = (x.astype(object) * y.astype(object)) >> 32
    err = exact - got
    assert err.min() >= 0 and err.max() <= 2, (err.min(), err.max())


@pytest.mark.parametrize("name", ["smallprime", "qtesla-i",
                                  "qtesla-iii-speed", "qtesla-p-i",
                                  "qtesla-p-iii"])
def test_fast_reduce_2q(rng, name):
    """[0, 2q) congruence for any uint32, via the sparse shift-add plan
    (qTESLA-I/III-speed, smallprime) or the sloppy-Shoup fallback."""
    ps = get_params(name)
    q = ps.q
    x = _rand_u32(rng, 0, 1 << 32, 8192)
    x[:5] = [0, q - 1, q, 2 * q, 0xFFFFFFFF]
    got = np.asarray(jax.jit(mm.fast_reduce_2q, static_argnums=(1, 2))(
        x, q, ps.one_shoup)).astype(object)
    assert (got < 2 * q).all(), got.max()
    np.testing.assert_array_equal(got % q, x.astype(object) % q)
    plan = mm.sparse_reduce_plan(q)
    if name in ("smallprime", "qtesla-i", "qtesla-iii-speed"):
        assert plan is not None
