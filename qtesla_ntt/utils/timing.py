"""Benchmark/timing harness.

Successor of the reference's QueryPerformanceCounter brackets and
polymuls/s printout (NTT.cu:2034-2083, main.cuh:8 NUM_AVE): device-synchronous
wall timing via block_until_ready, explicit warmup (so, unlike the reference,
compile time and host<->device staging are excluded from steady-state
numbers), mean/min/std over N iterations, and an optional jax.profiler trace.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import jax

__all__ = ["BenchResult", "measure", "measure_streamed",
           "benchmark_polymul", "benchmark_polymul_streamed",
           "benchmark_reduction"]


@dataclasses.dataclass
class BenchResult:
    name: str
    iters: int
    mean_s: float
    min_s: float
    std_s: float
    items_per_iter: int = 1
    median_s: float = 0.0

    @classmethod
    def from_times(cls, times, *, name: str, iters: int,
                   items_per_iter: int = 1) -> "BenchResult":
        """Robust statistics over per-iteration times.  One host hiccup in
        a repeat must not move the reported numbers: the headline statistic
        is the MIN (device time is a lower bound that hiccups only inflate),
        with the median as the robust central tendency."""
        return cls(
            name=name, iters=iters, mean_s=statistics.fmean(times),
            min_s=min(times), median_s=statistics.median(times),
            std_s=statistics.stdev(times) if len(times) > 1 else 0.0,
            items_per_iter=items_per_iter)

    @property
    def mean_ms(self) -> float:
        return self.mean_s * 1e3

    @property
    def throughput(self) -> float:
        """items/s based on the median iteration time (robust against
        outlier repeats; see from_times)."""
        return self.items_per_iter / (self.median_s or self.mean_s)

    @property
    def throughput_best(self) -> float:
        """items/s based on the best (min) iteration time — robust against
        host hiccups that inflate the mean but not device time.
        This is the statistic bench.py's JSON line reports."""
        return self.items_per_iter / self.min_s

    def line(self) -> str:
        """One diagnostic line.  The printed items/s uses the SAME statistic
        as bench.py's JSON (min-based throughput_best), so the human-readable
        and machine-readable outputs can never disagree."""
        med = (self.median_s or self.mean_s) * 1e3
        return (f"{self.name}: {med:.3f} ms/iter "
                f"(min {self.min_s * 1e3:.3f}, mean {self.mean_ms:.3f}, "
                f"std {self.std_s * 1e3:.3f}) "
                f"-> {self.throughput_best:,.0f} items/s")


def measure(fn: Callable, *args, warmup: int = 3, iters: int = 10,
            items_per_iter: int = 1, name: str = "bench",
            trace_dir: str | None = None, chain: bool = False,
            repeats: int = 3, inner: int = 1) -> BenchResult:
    """Time fn(*args).

    chain=False: device sync per iteration (includes host dispatch latency —
    the closest analog of the reference's per-loop timing, NTT.cu:2034-2081).

    chain=True: fn's output is fed back as its LAST argument, iters calls are
    enqueued back-to-back and synced once — measures pure device throughput.
    `warmup` is IGNORED in this mode: the pre-timing _run() pass compiles
    and warms the one program that is timed (see below), and an eager
    warmup would only compile a never-timed standalone program.
    `repeats` chained runs give mean/min/std of the per-iteration time.

    inner>1 (chain mode only): each scan step calls fn `inner` times
    back-to-back (z -> fn(.., z) -> fn(.., z) ...) and every recorded time
    is per CALL (step time / inner), so all statistics stay per-call and
    downstream consumers are unchanged; it amortizes a fixed per-step cost
    while every unit of reported work remains a real executed call.
    """
    if inner > 1:
        if not chain:
            raise ValueError("inner>1 requires chain=True")
        base_fn = fn

        def fn(*a):  # noqa: F811 - inner-fold chained body
            head, c = a[:-1], a[-1]
            for _ in range(inner):
                c = base_fn(*head, c)
            return c

        iters = max(1, iters // inner)
    if chain:
        # eager warmup would compile the STANDALONE fn — a program the
        # timing never runs (the scan inlines the jitted fn into _loop,
        # which _run() below compiles and warms).  Skipping it saves one
        # compile per chained configuration.
        warmup = 0
    for _ in range(warmup):
        out = fn(*args)
    if warmup:
        jax.block_until_ready(out)
    times = []
    ctx = None

    def _trace_on():
        # entered only AFTER compilation so the profile shows steady-state
        # device execution, not one giant compile
        nonlocal ctx
        if trace_dir:
            ctx = jax.profiler.trace(trace_dir)
            ctx.__enter__()

    try:
        if chain:
            import numpy as _np
            from jax import lax

            # the iteration loop lives INSIDE one jit (lax.scan): a single
            # dispatch covers all iters, amortizing per-call host overhead;
            # the final 4-byte readback forces completion
            @jax.jit
            def _loop(*a):
                head, tail = a[:-1], a[-1]

                def body(c, _):
                    return fn(*head, c), None

                out, _ = lax.scan(body, tail, None, length=iters)
                return out

            def _run():
                out = _loop(*args)
                leaf = jax.tree_util.tree_leaves(out)[0]
                _ = _np.asarray(leaf.reshape(-1)[:1])

            _run()  # compile + warm the whole chained pipeline once
            _trace_on()
            for _ in range(repeats):
                t0 = time.perf_counter()
                _run()
                times.append((time.perf_counter() - t0) / (iters * inner))
        else:
            if not warmup:
                jax.block_until_ready(fn(*args))  # ensure compiled
            _trace_on()
            for _ in range(iters):
                t0 = time.perf_counter()
                out = fn(*args)
                jax.block_until_ready(out)
                times.append(time.perf_counter() - t0)
    finally:
        if ctx:
            ctx.__exit__(None, None, None)
    return BenchResult.from_times(times, name=name, iters=iters,
                                  items_per_iter=items_per_iter)


def measure_streamed(fn: Callable, *host_args, warmup: int = 2,
                     iters: int = 10, items_per_iter: int = 1,
                     name: str = "bench") -> BenchResult:
    """Transfer-INCLUSIVE timing: each iteration stages the numpy operands
    host->device, runs fn, and fetches the full result back to numpy.

    This is the reference's headline bracket (NTT.cu:2036-2079: cudaMemcpy
    H2D + kernels + D2H inside the timed loop): it answers "what if
    operands arrive from host RAM each call" — the serving case
    `measure(chain=True)` deliberately excludes.  The number is a property
    of the host-device link as much as of the device."""
    import numpy as np
    import jax.numpy as jnp

    def one():
        dev = tuple(jnp.asarray(a) for a in host_args)
        return np.asarray(fn(*dev))

    for _ in range(warmup):
        one()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        one()
        times.append(time.perf_counter() - t0)
    return BenchResult.from_times(times, name=name, iters=iters,
                                  items_per_iter=items_per_iter)


def benchmark_polymul_streamed(param_set: str, algo: str = "merged",
                               batch: int = 4096, iters: int = 10,
                               warmup: int = 2, seed: int = 0) -> BenchResult:
    """Streamed (transfer-inclusive) negacyclic polymul throughput: operands
    start in host RAM every iteration and the product is fetched back — the
    reference's PCIe-inclusive measurement capability (NTT.cu:2036-2079)."""
    import numpy as np
    from ..models import polymul_fn
    from ..params import get_params

    ps = get_params(param_set)
    rng = np.random.default_rng(seed)
    x = rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32)
    fn = polymul_fn(param_set, algo)
    return measure_streamed(
        fn, x, y, warmup=warmup, iters=iters, items_per_iter=batch,
        name=f"polymul_streamed[{param_set},{algo},B={batch}]")


def benchmark_polymul(param_set: str, algo: str = "merged",
                      batch: int = 4096, iters: int = 20,
                      warmup: int = 3, seed: int = 0,
                      trace_dir: str | None = None,
                      chain: bool = True, inner: int = 1) -> BenchResult:
    """Steady-state batched negacyclic polymul throughput on the default
    backend (the reference's polymuls/s metric, NTT.cu:2083).  Chained by
    default: z_{i+1} = polymul(x, z_i) keeps the device busy back-to-back and
    excludes host dispatch latency."""
    import numpy as np
    import jax.numpy as jnp
    from ..models import polymul_fn
    from ..params import get_params

    ps = get_params(param_set)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32))
    y = jnp.asarray(rng.integers(0, ps.q, (batch, ps.n), dtype=np.uint32))
    fn = polymul_fn(param_set, algo)
    return measure(fn, x, y, warmup=warmup, iters=iters,
                   items_per_iter=batch, chain=chain, inner=inner,
                   name=f"polymul[{param_set},{algo},B={batch}"
                        + (f",x{inner}" if inner > 1 else "") + "]",
                   trace_dir=trace_dir)


def benchmark_reduction(param_set: str, op: str = "shoup",
                        size: int = 1 << 22, iters: int = 50,
                        seed: int = 0, inner: int = 1) -> BenchResult:
    """Modular-reduction microbenchmark (the reference's red_assembly /
    test_reduction experiment, NTT.cu:282-377, reborn as element-throughput
    of each reduction primitive)."""
    import functools
    import jax
    import numpy as np
    import jax.numpy as jnp
    from ..ops import modmul as mm
    from ..params import get_params

    ps = get_params(param_set)
    q = ps.q
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.integers(0, q, size, dtype=np.uint32))
    w = jnp.asarray(rng.integers(0, q, size, dtype=np.uint32))
    wsh = jnp.asarray(((np.asarray(w).astype(object) << 32) // q)
                      .astype(np.uint32))
    if op == "shoup":
        fn = jax.jit(lambda a, b: mm.shoup_mulmod(b, w, wsh, q))
    elif op == "barrett":
        fn = jax.jit(functools.partial(
            mm.mulmod_barrett, q=q, r32=ps.r32, r32_shoup=ps.r32_shoup,
            one_shoup=ps.one_shoup))
    elif op == "addmod":
        fn = jax.jit(lambda a, b: mm.add_mod(a, b, q))
    elif op == "mulhi":
        fn = jax.jit(mm.mulhi32)
    else:
        raise ValueError(f"unknown reduction op {op!r}")
    return measure(fn, x, x, warmup=2, iters=iters, chain=True,
                   items_per_iter=size, inner=inner,
                   name=f"reduction[{param_set},{op},{size}"
                        + (f",x{inner}" if inner > 1 else "") + "]")
