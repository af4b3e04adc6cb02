"""End-to-end negacyclic polymul pipeline tests: every algorithm, every
parameter set, vs the schoolbook big-int oracle and the all-ones closed form
(reference known-answer fixture, NTT.cu:1822 ff)."""

import numpy as np
import pytest

from qtesla_ntt.models import ALGORITHMS, polymul_negacyclic
from qtesla_ntt.oracle import (all_ones_square_closed_form,
                               negacyclic_schoolbook)
from qtesla_ntt.params import get_params

PIPELINES = sorted(ALGORITHMS)


@pytest.mark.parametrize("algo", PIPELINES)
def test_all_pipelines_vs_schoolbook_smallprime(rng, algo):
    ps = get_params("smallprime")
    x = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo=algo))
    for b in range(4):
        want = negacyclic_schoolbook(x[b], y[b], ps)
        np.testing.assert_array_equal(z[b].astype(np.uint64), want)


@pytest.mark.parametrize("algo", PIPELINES)
def test_all_pipelines_vs_schoolbook_qtesla_i(rng, algo):
    ps = get_params("qtesla-i")
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo=algo))
    want = negacyclic_schoolbook(x[0], y[0], ps)
    np.testing.assert_array_equal(z[0].astype(np.uint64), want)


@pytest.mark.parametrize("name", ["qtesla-i", "qtesla-iii-speed",
                                  "qtesla-p-i", "qtesla-p-iii"])
def test_all_ones_closed_form_all_sets(name):
    """z = (1+X+...)^2 mod (X^n+1): z[i] = (2i+2-n) mod q — the reference's
    manual-inspection fixture, automated."""
    ps = get_params(name)
    ones = np.ones((1, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(ones, ones, ps, algo="merged"))
    np.testing.assert_array_equal(z[0].astype(np.uint64),
                                  all_ones_square_closed_form(ps))


@pytest.mark.parametrize("name", [
    "smallprime",
    pytest.param("qtesla-iii-speed", marks=pytest.mark.slow),
    pytest.param("qtesla-p-i", marks=pytest.mark.slow),
    pytest.param("qtesla-p-iii", marks=pytest.mark.slow)])
def test_merged_vs_stockham_cross_algorithm(rng, name):
    """Independent-algorithm cross-check on the big sets (the reference uses
    Nussbaumer-vs-NTT the same way; see test_nussbaumer.py for that one)."""
    ps = get_params(name)
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    za = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    zb = np.asarray(polymul_negacyclic(x, y, ps, algo="stockham"))
    np.testing.assert_array_equal(za, zb)
    zc = np.asarray(polymul_negacyclic(x, y, ps, algo="four_step"))
    np.testing.assert_array_equal(za, zc)


def test_ramp_fixture_merged():
    """The reference's deterministic ramp operand (init_operand: lower half
    x[i] = n/2 - i, upper half zero — NTT.cu:4-21) through the flagship
    pipeline vs schoolbook."""
    ps = get_params("smallprime")
    n = ps.n
    x = np.zeros((1, n), dtype=np.uint32)
    x[0, :n // 2] = (n // 2 - np.arange(n // 2)) % ps.q
    z = np.asarray(polymul_negacyclic(x, x, ps, algo="merged"))
    want = negacyclic_schoolbook(x[0], x[0], ps)
    np.testing.assert_array_equal(z[0].astype(np.uint64), want)


def test_unknown_algo_raises():
    ps = get_params("smallprime")
    x = np.ones((1, ps.n), dtype=np.uint32)
    with pytest.raises(ValueError, match="unknown algorithm"):
        polymul_negacyclic(x, x, ps, algo="does-not-exist")


@pytest.mark.slow
def test_differential_fuzz_vs_native_oracle(rng):
    """Differential fuzz: random (param set, algorithm, batch, operand
    distribution) configurations against the native C++ schoolbook oracle
    (falls back to the big-int numpy oracle when csrc isn't built)."""
    from qtesla_ntt.utils import native
    from qtesla_ntt.oracle import negacyclic_schoolbook

    cases = []
    sets = ["smallprime", "qtesla-i", "qtesla-iii-speed", "qtesla-p-i"]
    algos = ["merged", "gs_ct", "ct_ct", "gs_gs", "ct_gs", "stockham",
             "four_step", "matrix"]
    for k in range(12):
        cases.append((sets[int(rng.integers(len(sets)))],
                      algos[int(rng.integers(len(algos)))],
                      int(rng.integers(1, 5))))
    for name, algo, B in cases:
        ps = get_params(name)
        mode = int(rng.integers(3))
        if mode == 0:                       # uniform
            x = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
            y = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
        elif mode == 1:                     # extremal
            x = np.full((B, ps.n), ps.q - 1, dtype=np.uint32)
            y = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
        else:                               # sparse (signature-like)
            x = np.zeros((B, ps.n), dtype=np.uint32)
            idx = rng.integers(0, ps.n, 30)
            x[:, idx] = rng.integers(0, ps.q, (B, 30), dtype=np.uint32)
            y = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
        z = np.asarray(polymul_negacyclic(x, y, ps, algo=algo))
        if native.native_available():
            want = native.negacyclic_schoolbook(x, y, ps.q)
        else:
            want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                             for b in range(B)]).astype(np.uint32)
        np.testing.assert_array_equal(
            z, want, err_msg=f"{name}/{algo}/B={B}/mode={mode}")


REAL_SETS = ["qtesla-i", "qtesla-iii-speed", "qtesla-p-i", "qtesla-p-iii"]


@pytest.mark.parametrize("name", REAL_SETS)
@pytest.mark.parametrize("shape", ["streamed", "fixed"])
def test_served_path_vs_oracle(rng, name, shape):
    """The served pipeline (algo=None, models.served_algo) at each real
    qTESLA modulus, every row against the C++ schoolbook oracle."""
    from qtesla_ntt.models import polymul_fixed_fn, polymul_fn
    from qtesla_ntt.oracle import mismatched_rows
    ps = get_params(name)
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    x[0] = ps.q - 1                          # extremal row
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    if shape == "streamed":
        z = polymul_fn(name)(x, y)
    else:
        prep, mul = polymul_fixed_fn(name)
        y = y[0]
        z = mul(x, prep(y[None])[0])
    assert mismatched_rows(x, y, np.asarray(z), ps, range(3)) == []


@pytest.mark.parametrize("algo", [a for a in PIPELINES if a != "merged"])
def test_pipelines_vs_oracle_qtesla_iii_speed(rng, algo):
    """The reference's explicit pairings and the other jnp pipelines at
    the reference's own modulus, against the C++ schoolbook oracle."""
    from qtesla_ntt.oracle import mismatched_rows
    ps = get_params("qtesla-iii-speed")
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo=algo))
    assert mismatched_rows(x, y, z, ps, range(2)) == []


@pytest.mark.parametrize("backend,n,want", [
    ("cpu", 1024, "merged"),
    ("gpu", 512, "fused"),
    ("gpu", 1024, "fused"),
    ("gpu", 2048, "fused"),
    ("gpu", 64, "merged"),        # not measured: stays on the reference
    ("gpu", 4096, "merged"),
])
def test_served_algo_choice(monkeypatch, backend, n, want):
    import jax
    from qtesla_ntt.models import served_algo
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert served_algo(n) == want


def test_default_algo_is_served():
    """algo=None resolves through served_algo: `merged` on the CPU."""
    from qtesla_ntt.models import polymul_fixed_fn, polymul_fn
    assert polymul_fn("smallprime") is polymul_fn("smallprime", "merged")
    with pytest.raises(ValueError, match="unknown fixed-operand"):
        polymul_fixed_fn("smallprime", "stockham")
