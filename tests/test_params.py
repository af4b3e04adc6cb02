"""Parameter registry / precompute tests (reference parity: main.cuh:7-30,
main.cu:18-65 root registry, constants.h tables)."""

import numpy as np
import pytest

from qtesla_ntt.params import available_param_sets, get_params

ALL_SETS = ["qtesla-i", "qtesla-iii-speed", "qtesla-p-i", "qtesla-p-iii",
            "smallprime"]


def test_registry_lists_all_sets():
    assert set(ALL_SETS) <= set(available_param_sets())


@pytest.mark.parametrize("name", ALL_SETS)
def test_root_properties(name):
    ps = get_params(name)
    n, q = ps.n, ps.q
    assert (q - 1) % (2 * n) == 0
    # psi is a primitive 2n-th root: psi^n = -1, psi^2n = 1
    assert pow(ps.psi, n, q) == q - 1
    assert pow(ps.psi, 2 * n, q) == 1
    # omega = psi^2 is a primitive n-th root
    assert pow(ps.omega, n, q) == 1
    assert pow(ps.omega, n // 2, q) == q - 1
    assert (ps.psi * ps.psi_inv) % q == 1
    assert (ps.n * ps.n_inv) % q == 1


def test_reference_qtesla_iii_constants_are_consistent():
    """The reference's hardcoded roots for qTESLA-III-speed (main.cu:25-27:
    fg0=2893, Ni=8396785, nfg0=6321631) satisfy the same defining equations
    our derived roots do — validating our derivation rules."""
    ps = get_params("qtesla-iii-speed")
    q, n = ps.q, ps.n
    assert q == 8404993 and n == 1024
    assert pow(2893, n, q) == 1 and pow(2893, n // 2, q) == q - 1
    assert (n * 8396785) % q == 1
    assert pow(6321631, n, q) == q - 1          # reference psi
    assert (6321631 * 2497826) % q == 1          # reference psi_inv
    assert pow(6321631, 2, q) == 2893            # psi^2 == omega


def test_smallprime_matches_reference_fixture():
    """main.cu:55: SMALLPRIME N=32 uses fg0=2, Ni=63489."""
    ps = get_params("smallprime")
    assert ps.q == 65537 and ps.n == 32
    assert pow(2, 32, 65537) == 1 and pow(2, 16, 65537) == 65536
    assert (32 * 63489) % 65537 == 1


@pytest.mark.parametrize("name", ["smallprime", "qtesla-i"])
def test_tables_exact(name):
    ps = get_params(name)
    n, q = ps.n, ps.q
    bits = ps.logn
    # psi_rev[i] == psi^bitrev(i)
    for i in [0, 1, 2, 3, n // 2, n - 1]:
        br = int(f"{i:0{bits}b}"[::-1], 2)
        assert int(ps.psi_rev[i]) == pow(ps.psi, br, q)
        assert int(ps.ipsi_rev[i]) == pow(ps.psi_inv, br, q)
        # Shoup companions
        assert int(ps.psi_rev_shoup[i]) == (int(ps.psi_rev[i]) << 32) // q
    # omega powers
    tf = ps.omega_powers(n)
    ti = ps.omega_powers(n, inverse=True)
    assert int(tf[1]) == ps.omega
    assert all((int(tf[i]) * int(ti[i])) % q == 1 for i in range(1, 8))
    # bitrev table is an involution/permutation
    br = ps.bitrev_tbl
    assert sorted(br.tolist()) == list(range(n))
    assert all(int(br[int(br[i])]) == i for i in range(n))


def test_scalar_constants():
    ps = get_params("qtesla-p-iii")
    assert ps.r32 == (1 << 32) % ps.q
    assert ps.one_shoup == (1 << 32) // ps.q
    assert 2 * ps.q < 1 << 31  # lazy [0,2q) fits signed/unsigned compare range


def test_rejects_bad_params():
    from qtesla_ntt.params import ParamSet
    with pytest.raises(ValueError):
        ParamSet(name="bad", n=48, q=65537)       # not a power of two
    with pytest.raises(ValueError):
        ParamSet(name="bad", n=4, q=7)            # q !≡ 1 mod 2n


def test_register_param_set_end_to_end(rng):
    """A runtime-registered NTT-friendly (n, q) flows through tables,
    pipelines and oracles (the reference needs a recompile for this,
    main.cuh:23-29)."""
    import numpy as np
    from qtesla_ntt.params import register_param_set, get_params
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.oracle import negacyclic_schoolbook
    # 7681 = 2^9*3*5 + 1: classic Kyber-toy prime, q = 1 mod 2n for n = 64
    ps = register_param_set("toy-7681", 64, 7681)
    assert get_params("toy-7681") == ps
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                     for b in range(3)]).astype(np.uint32)
    np.testing.assert_array_equal(z, want)
    # re-registration with identical values is idempotent; conflict raises
    register_param_set("toy-7681", 64, 7681)
    import pytest
    with pytest.raises(ValueError):
        register_param_set("toy-7681", 128, 7681)


def test_runtime_registered_set_mxu_and_nussbaumer(rng):
    """Extends test_register_param_set_end_to_end: the fused kernel
    (interpret) and the exact mod-q Nussbaumer also work on a
    RUNTIME-registered set, with adversarial all-(q-1) operands."""
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.oracle import negacyclic_schoolbook
    from qtesla_ntt.ops.ntt_pallas import polymul_fused_fn
    from qtesla_ntt.params import register_param_set

    ps = register_param_set("toy-7681", 64, 7681)   # idempotent re-register
    x = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (3, ps.n), dtype=np.uint32)
    x[0, :] = ps.q - 1
    y[0, :] = ps.q - 1
    want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                     for b in range(3)]).astype(np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="nussbaumer"))
    np.testing.assert_array_equal(z.astype(np.uint32), want)
    z = np.asarray(polymul_fused_fn("toy-7681", interpret=True)(x, y))
    np.testing.assert_array_equal(z, want)


@pytest.mark.exhaustive
def test_dilithium_prime_and_n4096_beyond_reference(rng):
    """Generality beyond the reference's hardcoded N=4..1024 ladder
    (main.cu:18-65): the Dilithium prime q=8380417=2^23-2^13+1 at n=256,
    and a 4x-larger-than-reference n=4096 transform on the same prime
    (8192 | q-1), each bit-exact vs the schoolbook oracle through both the
    jnp pipeline and the fused kernel (interpret)."""
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.oracle import negacyclic_schoolbook
    from qtesla_ntt.ops.ntt_pallas import polymul_fused_fn
    from qtesla_ntt.params import register_param_set

    for name, n in [("dilithium-256", 256), ("dilithium-4096", 4096)]:
        ps = register_param_set(name, n=n, q=8380417)
        B = 2
        x = rng.integers(0, ps.q, (B, n), dtype=np.uint32)
        y = rng.integers(0, ps.q, (B, n), dtype=np.uint32)
        x[0, :] = ps.q - 1
        y[0, :] = ps.q - 1
        want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                         for b in range(B)]).astype(np.uint32)
        z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
        np.testing.assert_array_equal(z, want, err_msg=f"{name} merged")
        z = np.asarray(polymul_fused_fn(name, interpret=True)(x, y))
        np.testing.assert_array_equal(z, want, err_msg=f"{name} fused")


def test_register_near_2pow30_prime(rng):
    """q = 2^30 - 2^18 + 1 (prime, q = 1 mod 2n for n <= 2^17) sits just
    under the lazy arithmetic's 4q < 2^32 bound: the jnp pipeline and the
    fused kernel (interpret), whose forward values reach 4q, must stay
    bit-exact with adversarial all-(q-1) operands."""
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.oracle import negacyclic_schoolbook
    from qtesla_ntt.ops.ntt_pallas import polymul_fused_fn
    from qtesla_ntt.params import register_param_set

    ps = register_param_set("toy-30bit", n=64, q=1073479681)
    x = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (2, ps.n), dtype=np.uint32)
    x[0, :] = ps.q - 1
    y[0, :] = ps.q - 1
    want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                     for b in range(2)]).astype(np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    np.testing.assert_array_equal(z, want, err_msg="merged")
    z = np.asarray(polymul_fused_fn("toy-30bit", interpret=True)(x, y))
    np.testing.assert_array_equal(z, want, err_msg="fused")


@pytest.mark.slow
def test_runtime_registered_n8192(rng):
    """n=8192 on the qTESLA-III-speed prime (8404993 = 1 mod 16384)
    through the unmodified registry and merged pipeline — 8x the
    reference's N<=1024 root ladder (main.cu:18-65)."""
    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.params import register_param_set

    ps = register_param_set("qtesla3s-8192-test", n=8192, q=8404993)
    assert pow(ps.psi, ps.n, ps.q) == ps.q - 1      # psi is a 2n-th root
    x = rng.integers(0, ps.q, (1, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (1, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
    from qtesla_ntt.utils import native
    if native.native_available():
        want = native.negacyclic_schoolbook(x, y, ps.q)
        np.testing.assert_array_equal(z, want)
    else:                       # round-trip + closed-form fallback
        from qtesla_ntt.oracle import all_ones_square_closed_form
        ones = np.ones((1, ps.n), dtype=np.uint32)
        zz = np.asarray(polymul_negacyclic(ones, ones, ps, algo="merged"))
        np.testing.assert_array_equal(
            zz[0], all_ones_square_closed_form(ps))
