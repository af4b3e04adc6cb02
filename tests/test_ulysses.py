"""Ulysses-style SP (batch<->position all_to_all around the single-chip
pipeline, parallel/ulysses.py) on the 8-virtual-device CPU mesh: bit-exact
vs the single-device flagship, across mesh shapes, padding, and the
fixed-operand variant."""

import numpy as np
import pytest

from qtesla_ntt.models import polymul_negacyclic
from qtesla_ntt.parallel import (make_mesh, polymul_fixed_ulysses_fn,
                                 polymul_sp_fn, polymul_ulysses_fn)
from qtesla_ntt.params import get_params


def _data(name, B, rng):
    ps = get_params(name)
    x = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
    return ps, x, y


@pytest.mark.parametrize("data,model", [(2, 4), (1, 8), (4, 2)])
def test_ulysses_bit_exact(rng, data, model):
    ps, x, y = _data("qtesla-iii-speed", 16, rng)
    fn = polymul_ulysses_fn(ps.name, make_mesh(data=data, model=model))
    z = np.asarray(fn(x, y))
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    assert (z == want).all()


@pytest.mark.slow
def test_ulysses_other_param_sets(rng):
    mesh = make_mesh(data=2, model=4)
    for name in ("smallprime", "qtesla-p-iii"):
        ps, x, y = _data(name, 8, rng)
        z = np.asarray(polymul_ulysses_fn(name, mesh)(x, y))
        want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
        assert (z == want).all(), name


def test_ulysses_ragged_batch_padded(rng):
    """B not divisible by data*model: transparently padded and sliced."""
    mesh = make_mesh(data=2, model=4)
    ps, x, y = _data("smallprime", 11, rng)   # padding logic is param-independent
    z = np.asarray(polymul_ulysses_fn(ps.name, mesh)(x, y))
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    assert z.shape == (11, ps.n) and (z == want).all()


def test_ulysses_fixed_operand(rng):
    mesh = make_mesh(data=2, model=4)
    ps = get_params("qtesla-iii-speed")
    a = rng.integers(0, ps.q, (ps.n,), dtype=np.uint32)
    x = rng.integers(0, ps.q, (16, ps.n), dtype=np.uint32)
    prep, mul = polymul_fixed_ulysses_fn(ps.name, mesh)
    z = np.asarray(mul(x, prep(a)))
    want = np.asarray(polymul_negacyclic(
        x, np.broadcast_to(a, x.shape), ps, algo="merged"))
    assert (z == want).all()


@pytest.mark.slow
def test_sp_dispatcher_picks_by_batch(rng):
    """polymul_sp_fn: Ulysses for batch >= data*model, four-step below;
    both bit-exact."""
    mesh = make_mesh(data=2, model=4)
    ps, x, y = _data("qtesla-iii-speed", 16, rng)
    zu = np.asarray(polymul_sp_fn(ps.name, mesh, batch_hint=16)(x, y))
    zf = np.asarray(polymul_sp_fn(ps.name, mesh, batch_hint=4)(x[:4], y[:4]))
    want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    assert (zu == want).all()
    assert (zf == want[:4]).all()
