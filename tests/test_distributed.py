"""Multi-host layer test: two real OS processes, each with 2 virtual CPU
devices, joined through the JAX coordination service — exercises
jax.distributed init, the hosts-major global mesh, cross-process batch
assembly, and both the DP and four-step-SP pipelines bit-exactly (the
"1 device -> 1 host -> N hosts" plumbing, testable without a cluster)."""

import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_cluster():
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), "2", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=_REPO, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"DIST OK pid={i}" in out, f"worker {i} output:\n{out}"


@pytest.mark.slow
def test_worker_death_detected_fail_fast():
    """Fault injection (SURVEY.md §5 failure-detection row): one worker
    joins the cluster then dies silently; the survivor's fail-fast
    `barrier` must raise within its 20s timeout — a timely error naming a
    detection, not a hung collective.  Recovery is stateless restart
    (see parallel.distributed.barrier docstring): nothing to checkpoint,
    so the test only asserts detection."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    modes = ["detect", "die"]
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(i), "2", str(port), modes[i]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=_REPO, env=env) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert procs[1].returncode == 0, f"dying worker:\n{outs[1]}"
    assert "DIST DYING pid=1" in outs[1]
    assert procs[0].returncode == 0, f"survivor:\n{outs[0]}"
    assert "FAULT DETECTED pid=0" in outs[0], outs[0]


def test_local_shard_rejects_non_batch_sharding():
    """local_shard must raise on arrays sharded along a non-leading axis
    instead of silently returning a partial slice (code-review finding)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from qtesla_ntt.parallel import local_shard, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(data=4, model=2)
    x = jnp.arange(64, dtype=jnp.uint32).reshape(8, 8)
    ok = jax.device_put(x, NamedSharding(mesh, P(("data", "model"), None)))
    np.testing.assert_array_equal(local_shard(ok), np.asarray(x))
    bad = jax.device_put(x, NamedSharding(mesh, P(None, "model")))
    with pytest.raises(ValueError, match="axis 0"):
        local_shard(bad)
