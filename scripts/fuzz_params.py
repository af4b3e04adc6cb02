"""Registration-space sweep: validate the full pipeline stack on many
runtime-registered (n, q) pairs across the supported modulus range.

The reference supports exactly two compile-time parameter sets
(main.cuh:7-30); this framework registers any power-of-two n with prime
q = 1 mod 2n up to 30 bits.  The lazy arithmetic of the fused kernel keeps
values below 4q < 2^32, so its margins shrink with the modulus: a
magnitude sweep is the right fuzz axis.  Every prime is checked bit-exactly
against the big-int schoolbook oracle through the merged jnp pipeline AND
the fused kernel (interpret mode), plus the sharded four-step SP (model=2)
where the split supports it.

Usage: JAX_PLATFORMS=cpu python scripts/fuzz_params.py [--n 64]
           [--per-decade 4] [--seed 0] [--sp]
"""

import argparse
import sys

import numpy as np

sys.path.insert(0, ".")

from sympy import isprime  # noqa: F401  (guarded import below)


def primes_for_n(n: int, per_decade: int, lo_bits: int = 15,
                 hi_bits: int = 30):
    """NTT-friendly primes q = c*2n + 1 spread across magnitudes: for each
    bit size, the smallest few valid primes (deterministic)."""
    out = []
    for bits in range(lo_bits, hi_bits + 1):
        found = 0
        c = ((1 << (bits - 1)) // (2 * n)) + 1
        while found < per_decade:
            q = c * 2 * n + 1
            if q >= 1 << bits:
                break
            if isprime(q):
                out.append(q)
                found += 1
            c += 1
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--per-decade", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sp", action="store_true",
                    help="also run the sharded four-step SP (model=2) "
                         "where the split allows")
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 2)

    from qtesla_ntt.models import polymul_negacyclic
    from qtesla_ntt.oracle import negacyclic_schoolbook
    from qtesla_ntt.ops.ntt_pallas import polymul_fused_fn
    from qtesla_ntt.params import register_param_set

    n = args.n
    rng = np.random.default_rng(args.seed)
    qs = primes_for_n(n, args.per_decade)
    print(f"n={n}: sweeping {len(qs)} primes, "
          f"{qs[0]} ({qs[0].bit_length()}b) .. {qs[-1]} "
          f"({qs[-1].bit_length()}b)", flush=True)
    failures = 0
    for q in qs:
        name = f"fuzz-{n}-{q}"
        try:
            ps = register_param_set(name, n=n, q=q)
            x = rng.integers(0, q, (2, n), dtype=np.uint32)
            y = rng.integers(0, q, (2, n), dtype=np.uint32)
            x[0, :] = q - 1           # adversarial max-coefficient row
            y[0, :] = q - 1
            want = np.stack([negacyclic_schoolbook(x[b], y[b], ps)
                             for b in range(2)]).astype(np.uint32)
            z = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
            assert (z == want).all(), "merged mismatch"
            z = np.asarray(polymul_fused_fn(name, interpret=True)(x, y))
            assert (z == want).all(), "fused mismatch"
            tag = "ok"
            if args.sp:
                from qtesla_ntt.parallel import (make_mesh,
                                                 polymul_fourstep_sharded_fn)
                n1 = 1 << (n.bit_length() - 1 >> 1)
                if n1 % 2 == 0 and (n // n1) % 2 == 0:
                    mesh = make_mesh(data=1, model=2)
                    zs = np.asarray(polymul_fourstep_sharded_fn(
                        name, mesh)(x, y))
                    assert (zs == want).all(), "sp mismatch"
                    tag += " sp=ok"
            print(f"  q={q:>11} ({q.bit_length():>2}b): {tag}", flush=True)
        except Exception as e:
            failures += 1
            print(f"  q={q:>11} ({q.bit_length():>2}b): FAIL {e!r}",
                  flush=True)
    print(f"{'FAILURES: %d' % failures if failures else 'all ok'}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
