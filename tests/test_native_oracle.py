"""Native C++ oracle (csrc/oracle.cpp via ctypes) vs the Python big-int
oracle, and as ground truth for the device pipelines."""

import numpy as np
import pytest

from qtesla_ntt.oracle import (negacyclic_schoolbook,
                               negacyclic_schoolbook_ring, ntt_naive)
from qtesla_ntt.params import get_params
from qtesla_ntt.utils import native

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="no C++ toolchain")


def test_cpp_schoolbook_matches_python(rng):
    ps = get_params("smallprime")
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    got = native.negacyclic_schoolbook(x, y, ps.q)
    for b in range(3):
        np.testing.assert_array_equal(got[b].astype(np.uint64),
                                      negacyclic_schoolbook(x[b], y[b], ps))


def test_cpp_ntt_matches_python(rng):
    ps = get_params("smallprime")
    x = rng.integers(0, ps.q, ps.n, dtype=np.uint32)
    got = native.ntt_naive(x, ps.q, ps.omega)
    np.testing.assert_array_equal(got.astype(np.uint64), ntt_naive(x, ps))
    rt = native.intt_naive(got, ps.q, ps.omega)
    np.testing.assert_array_equal(rt, x)


def test_cpp_ring_matches_python(rng):
    x = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    got = native.negacyclic_schoolbook_ring(x, y)
    np.testing.assert_array_equal(got.astype(np.uint64),
                                  negacyclic_schoolbook_ring(x, y))


@pytest.mark.parametrize("name", ["qtesla-i", "qtesla-p-iii"])
def test_cpp_polymul_ntt_self_consistent(rng, name):
    """C++ naive-NTT polymul vs C++ schoolbook — two independent native
    paths (full-range operands, big sets where python oracles are slow)."""
    ps = get_params(name)
    x = rng.integers(0, ps.q, (1, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (1, ps.n), dtype=np.uint32)
    a = native.polymul_ntt(x[0], y[0], ps.q, ps.psi)
    b = native.negacyclic_schoolbook(x, y, ps.q)[0]
    np.testing.assert_array_equal(a, b)


def test_device_pipeline_vs_cpp_oracle(rng):
    """The merged pipeline against the native oracle at full range
    (qtesla-iii-speed) — the primary bit-exactness gate."""
    from qtesla_ntt.models import polymul_negacyclic
    ps = get_params("qtesla-iii-speed")
    x = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (4, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(z, native.negacyclic_schoolbook(x, y, ps.q))
