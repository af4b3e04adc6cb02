"""Worker for the 2-process multi-host CPU test (tests/test_distributed.py).

Each process owns 2 virtual CPU devices; together they form a 2-host,
4-device cluster wired through the JAX coordination service — the same
`jax.distributed` + hosts-major-mesh code path a multi-host GPU cluster
uses, minus the hardware (SURVEY.md §5 distributed row).

Usage: python tests/_dist_worker.py <process_id> <num_processes> <port> [mode]

Modes: "ok" (default) runs the full DP/SP pipeline checks; the fault-
injection pair "die" (exit silently right after joining the cluster —
a simulated host death) and "detect" (survivor: expect the fail-fast
barrier to raise within its timeout instead of hanging) exercises the
failure-detection story (SURVEY.md §5 failure-detection row).
"""

import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
mode = sys.argv[4] if len(sys.argv) > 4 else "ok"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qtesla_ntt.models import polymul_negacyclic  # noqa: E402
from qtesla_ntt.params import get_params  # noqa: E402
from qtesla_ntt.parallel import polymul_dp_fn  # noqa: E402
from qtesla_ntt.parallel.distributed import (  # noqa: E402
    global_batch, init_distributed, local_shard, make_global_mesh)
from qtesla_ntt.parallel.sharded import (  # noqa: E402
    polymul_fourstep_sharded_fn)

init_distributed(f"localhost:{port}", nproc, pid)
assert jax.process_count() == nproc, jax.process_count()

if mode == "die":
    # simulated host death: leave the cluster without a word, BEFORE any
    # collective work (the survivor's barrier must detect it)
    print(f"DIST DYING pid={pid}", flush=True)
    os._exit(0)
if mode == "detect":
    import time
    from qtesla_ntt.parallel.distributed import barrier, live_processes
    t0 = time.monotonic()
    try:
        barrier("failure-probe", timeout_s=20.0)
    except Exception as e:
        dt = time.monotonic() - t0
        assert dt < 60.0, f"detection took {dt:.0f}s (not fail-fast)"
        # the liveness snapshot names the survivor set for the restart
        alive = live_processes()
        print(f"FAULT DETECTED pid={pid} after {dt:.1f}s alive={alive} "
              f"({type(e).__name__})", flush=True)
        # leave WITHOUT the atexit jax.distributed.shutdown(): its shutdown
        # barrier would wait on the dead peer until the heartbeat watchdog
        # force-kills us.  The recovery model is orchestrator restart, and
        # a restarting worker exits exactly like this.
        os._exit(0)
    raise SystemExit("barrier did not detect the dead peer")

assert len(jax.devices()) == 2 * nproc, jax.devices()

name = "smallprime"
ps = get_params(name)
B = 4 * nproc
rng = np.random.default_rng(99)       # same full batch on every process
x = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
y = rng.integers(0, ps.q, (B, ps.n), dtype=np.uint32)
want = np.asarray(polymul_negacyclic(x, y, ps, algo="merged"))
rows = slice(pid * (B // nproc), (pid + 1) * (B // nproc))

# 1) pure-DP over (data=4, model=1): batch axis spans DCN
mesh = make_global_mesh(model=1)
assert mesh.shape["data"] == 2 * nproc
gx = global_batch(mesh, x[rows])
gy = global_batch(mesh, y[rows])
z = polymul_dp_fn(name, mesh, algo="merged")(gx, gy)
np.testing.assert_array_equal(local_shard(z), want[rows])

# 2) DP x SP over (data=nproc, model=2): the four-step all_to_all stays
# inside each process; only batch sharding crosses processes
from jax.sharding import PartitionSpec as P  # noqa: E402

mesh2 = make_global_mesh(model=2)
gx2 = global_batch(mesh2, x[rows], P("data", None))
gy2 = global_batch(mesh2, y[rows], P("data", None))
z2 = polymul_fourstep_sharded_fn(name, mesh2)(gx2, gy2)
np.testing.assert_array_equal(local_shard(z2), want[rows])

print(f"DIST OK pid={pid}", flush=True)
