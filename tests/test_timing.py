"""Timing-harness regression tests (CPU)."""

import numpy as np
import pytest

import jax.numpy as jnp

from qtesla_ntt.utils.timing import BenchResult, measure


def _add(a, b):
    return a + b


def test_measure_warmup_zero():
    """warmup=0 must not crash (regression: NameError on `out`)."""
    x = jnp.ones((8, 8), jnp.uint32)
    r = measure(_add, x, x, warmup=0, iters=2, chain=False, name="w0")
    assert r.iters == 2 and r.mean_s > 0


def test_measure_chain_and_throughput():
    x = jnp.ones((4, 8), jnp.uint32)
    r = measure(_add, x, x, warmup=1, iters=3, items_per_iter=4,
                chain=True, repeats=2, name="c")
    assert r.throughput_best >= r.throughput > 0


@pytest.mark.slow
def test_measure_trace_dir(tmp_path):
    """--trace-dir path: profile written, steady-state only (post-compile)."""
    x = jnp.ones((4, 8), jnp.uint32)
    d = str(tmp_path / "trace")
    r = measure(_add, x, x, warmup=1, iters=2, chain=True,
                trace_dir=d, name="t")
    import os
    assert r.mean_s > 0 and os.path.isdir(d) and os.listdir(d)


def test_bench_result_line():
    r = BenchResult(name="x", iters=3, mean_s=0.002, min_s=0.001,
                    std_s=0.0, items_per_iter=10)
    assert "items/s" in r.line() and r.throughput == 5000


def test_outlier_repeat_does_not_inflate_reported_numbers():
    """Regression: one host hiccup among the chained
    repeats must not move the reported throughput — stats are min/median
    based, and line() prints the same statistic the bench JSON uses."""
    times = [0.0417, 0.0032, 0.0031]     # the observed 13x outlier shape
    r = BenchResult.from_times(times, name="o", iters=400,
                               items_per_iter=16384)
    assert r.min_s == 0.0031 and r.median_s == 0.0032
    best = 16384 / 0.0031
    assert r.throughput_best == best
    # median-based central throughput unaffected by the outlier
    assert abs(r.throughput - 16384 / 0.0032) < 1e-6
    # the human-readable line carries the min-based number, not mean-based
    assert f"{best:,.0f} items/s" in r.line()
    assert f"{16384 / r.mean_s:,.0f}" not in r.line()
