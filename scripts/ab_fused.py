"""A/B of the fused Pallas kernel against the `merged` XLA pipeline on one
GPU, in one process, in turns (merged, fused, fused, merged) per round.

    python scripts/ab_fused.py [--rounds 5] [--calls 20] [--out FILE]

Cells: qtesla-iii-speed at B=16384 and 32768, and qtesla-i (n=512) and
qtesla-p-iii (n=2048) at B=32768; each with two streamed operands and with
a fixed operand.  A run is `calls` back-to-back calls ended by
block_until_ready; its time per call is recorded.  Each cell reports the
median and quartiles of both sides, and the number of device kernels one
call launches, read from a jax.profiler trace of three calls.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CELLS = [("qtesla-iii-speed", 16384), ("qtesla-iii-speed", 32768),
         ("qtesla-i", 32768), ("qtesla-p-iii", 32768)]


def _kernels_per_call(fn, args, calls: int = 3, show: bool = False) -> int:
    """Device kernel events in a trace of `calls` calls, per call.  `show`
    prints every device line with its event count and first names."""
    import jax
    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(calls):
                out = fn(*args)
            jax.block_until_ready(out)
        [path] = [os.path.join(r, f) for r, _, fs in os.walk(d)
                  for f in fs if f.endswith(".xplane.pb")]
        data = jax.profiler.ProfileData.from_file(path)
        n = 0
        for plane in data.planes:
            if not plane.name.startswith("/device:GPU:0"):
                continue
            for line in plane.lines:
                if show:
                    names = [e.name for e in line.events]
                    print(f"  trace {plane.name} / {line.name}: "
                          f"{len(names)} events {names[:4]}")
                if line.name.startswith("Stream"):
                    n += sum(1 for e in line.events
                             if not e.name.startswith("Memcpy")
                             and not e.name.startswith("Memset"))
    return round(n / calls)


def _run_time(fn, args, calls: int) -> float:
    import jax
    t0 = time.perf_counter()
    for _ in range(calls):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / calls


def _stats(ts):
    q = statistics.quantiles(ts, n=4)
    return {"median_ms": statistics.median(ts) * 1e3,
            "q1_ms": q[0] * 1e3, "q3_ms": q[2] * 1e3,
            "runs_ms": [t * 1e3 for t in ts]}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--out", default="chiprun_out/ab_fused.json")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from qtesla_ntt.models import polymul_fixed_fn, polymul_fn
    from qtesla_ntt.params import get_params
    from qtesla_ntt.utils.cache import enable_compile_cache
    from qtesla_ntt.utils.device import require_gpu

    enable_compile_cache()
    dev = require_gpu("ab_fused.py")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for name, batch in CELLS:
        ps = get_params(name)
        rng = np.random.default_rng(0)
        x = jnp.asarray(rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32))
        y = jnp.asarray(rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32))
        for shape in ("streamed", "fixed"):
            if shape == "streamed":
                fns = {a: polymul_fn(name, a) for a in ("merged", "fused")}
                fargs = (x, y)
            else:
                prep, _ = polymul_fixed_fn(name, "merged")
                fns = {a: polymul_fixed_fn(name, a)[1]
                       for a in ("merged", "fused")}
                fargs = (x, prep(y[:1])[0])
            outs = {a: np.asarray(f(*fargs)) for a, f in fns.items()}
            exact = bool((outs["merged"] == outs["fused"]).all())
            times = {a: [] for a in fns}
            for _ in range(args.rounds):
                for a in ("merged", "fused", "fused", "merged"):
                    times[a].append(_run_time(fns[a], fargs, args.calls))
            row = {"param_set": name, "n": ps.n, "batch": batch,
                   "shape": shape, "bit_exact": exact}
            for a in fns:
                row[a] = _stats(times[a])
                row[a]["kernels_per_call"] = _kernels_per_call(
                    fns[a], fargs, show=not rows and shape == "streamed")
                row[a]["polymuls_per_s"] = batch / (
                    row[a]["median_ms"] * 1e-3)
            row["speedup"] = row["merged"]["median_ms"] / row["fused"][
                "median_ms"]
            rows.append(row)
            print(f"{name} B={batch} {shape}: merged "
                  f"{row['merged']['median_ms']:.4f} ms "
                  f"[{row['merged']['q1_ms']:.4f}, "
                  f"{row['merged']['q3_ms']:.4f}] "
                  f"({row['merged']['kernels_per_call']} kernels), fused "
                  f"{row['fused']['median_ms']:.4f} ms "
                  f"[{row['fused']['q1_ms']:.4f}, "
                  f"{row['fused']['q3_ms']:.4f}] "
                  f"({row['fused']['kernels_per_call']} kernels), "
                  f"x{row['speedup']:.2f}, bit_exact={exact}", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "device_kind": dev.device_kind,
                   "rounds": args.rounds, "calls": args.calls,
                   "cells": rows}, f, indent=1)
    return 0 if all(r["bit_exact"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
