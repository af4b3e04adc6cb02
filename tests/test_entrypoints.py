"""Entry points that must not run without a GPU, the compile-cache helper,
and the sampled oracle comparison the GPU entry points rely on."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from qtesla_ntt.oracle import mismatched_rows, sample_rows
from qtesla_ntt.params import get_params
from qtesla_ntt.utils import cache

ROOT = Path(__file__).resolve().parent.parent


def _run_cpu(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_refuses_without_gpu(script):
    """No GPU: exit non-zero, say why, print no result."""
    cp = _run_cpu(ROOT / script, ROOT)
    assert cp.returncode != 0
    assert "needs a GPU" in cp.stderr
    assert '"ok"' not in cp.stdout and '"value"' not in cp.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    cp = _run_cpu(tmp_path / "chip_smoke.py", tmp_path)
    assert cp.returncode != 0 and '"ok"' not in cp.stdout


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_dir(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(ROOT / ".jax_cache")
    assert cache.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("batch,k", [(32768, 64), (5, 64), (3, 2)])
def test_sample_rows(batch, k):
    rows = sample_rows(batch, k, seed=3)
    assert len(rows) == min(batch, k) == len(set(rows.tolist()))
    assert rows[0] == 0 and rows[-1] == batch - 1
    assert (np.diff(rows) > 0).all()


@pytest.mark.parametrize("row", [0, 3, 7])
@pytest.mark.parametrize("fixed", [False, True])
def test_mismatched_rows_catches_one_flip(rng, row, fixed):
    """One flipped coefficient in one sampled row is reported, and only
    that row."""
    from qtesla_ntt.utils import native
    ps = get_params("qtesla-iii-speed")
    x = rng.integers(0, ps.q, (8, ps.n), dtype=np.uint32)
    y = rng.integers(0, ps.q, (8, ps.n), dtype=np.uint32)
    if fixed:
        y = y[0]
    z = native.negacyclic_schoolbook(x, np.broadcast_to(y, x.shape), ps.q)
    assert mismatched_rows(x, y, z, ps, range(8)) == []
    z[row, 17] ^= 1
    assert mismatched_rows(x, y, z, ps, range(8)) == [row]
    assert mismatched_rows(x, y, z, ps, [r for r in range(8)
                                         if r != row]) == []
