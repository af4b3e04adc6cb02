"""Single-cell benchmark on one GPU: steady-state batched negacyclic polymul
throughput at qtesla-iii-speed (n=1024, q=8404993), B=32768, two operands
resident on the device, through the served pipeline (models.served_algo).
This is the reference's headline metric (polymuls/s, NTT.cu:2083) with the
warmup and compilation excluded.

Prints ONE JSON line, the last line on stdout:
  {"metric": ..., "value": N, "unit": "polymuls/s", "vs_baseline": N,
   "device": {"platform", "kind", "count"}, "algo": ..., "bit_exact": true}

vs_baseline: the reference repo publishes no numbers, so the denominator is
REFERENCE_ESTIMATE = 1e6 polymuls/s — an estimate of the reference's
pipeline at this n (its shipped config times 2 polymuls per loop including
PCIe transfers).

Exits non-zero, and prints no result, without a GPU or when a sampled row
of the output differs from the C++ schoolbook oracle.
"""

import json
import sys

REFERENCE_ESTIMATE = 1.0e6   # polymuls/s, see module docstring

PARAM_SET = "qtesla-iii-speed"
BATCH = 32768
ITERS = 400
INNER = 4                    # calls per scan step (utils.timing.measure)
SAMPLE_ROWS = 64


def main() -> int:
    import jax
    import numpy as np

    from qtesla_ntt.models import polymul_fn, served_algo
    from qtesla_ntt.oracle import mismatched_rows, sample_rows
    from qtesla_ntt.params import get_params
    from qtesla_ntt.utils import device, timing
    from qtesla_ntt.utils.cache import enable_compile_cache

    enable_compile_cache()
    dev = device.require_gpu("bench.py")
    ps = get_params(PARAM_SET)
    algo = served_algo(ps.n)

    rng = np.random.default_rng(1)
    x = rng.integers(0, ps.q, (BATCH, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (BATCH, ps.n), dtype=np.uint32)
    z = np.asarray(polymul_fn(PARAM_SET, algo)(x, y))
    bad = mismatched_rows(x, y, z, ps, sample_rows(BATCH, SAMPLE_ROWS))
    if bad:
        print(f"bench.py: {algo} output differs from the oracle at rows "
              f"{bad[:8]}", file=sys.stderr)
        return 1

    r = timing.benchmark_polymul(PARAM_SET, algo, batch=BATCH, iters=ITERS,
                                 inner=INNER)
    print(f"# {r.line()}", file=sys.stderr)
    value = r.throughput_best          # min-time based; see timing.py
    print(json.dumps({
        "metric": f"negacyclic polymuls/s (n={ps.n}, q={ps.q}, "
                  f"batch={BATCH}, algo={algo}, chained x{INNER}/step)",
        "value": round(value, 1),
        "unit": "polymuls/s",
        "vs_baseline": round(value / REFERENCE_ESTIMATE, 3),
        "baseline_is_estimate": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "algo": algo,
        "bit_exact": True,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
