"""Multi-host (multi-process) execution layer.

The reference is single-GPU/single-process (SURVEY.md §2.4).  This module
is the multi-host story: `jax.distributed` initialization, a hosts-major
global mesh whose data axis spans processes (batch shards cross the
network between hosts — the embarrassingly-parallel axis) while the model
axis stays inside one process (the four-step and Ulysses all_to_alls stay
on the host's own device links), and helpers to assemble global arrays
from per-process batch shards.

Tested without a pod: two spawned CPU-backend processes with the JAX
coordination service and gloo cross-process collectives run the same code
path bit-exactly (tests/test_distributed.py), mirroring how the virtual
8-CPU-device mesh stands in for one multi-device host.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "make_global_mesh", "global_batch",
           "local_shard", "barrier", "live_processes"]


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the JAX distributed runtime (multi-host entry point).

    Arguments default to the standard environment variables
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Safe to call once per process,
    BEFORE any device query.  On CPU backends this also selects gloo
    cross-process collectives so the same mesh code runs in tests."""
    # NOTE: must not touch jax.devices()/process_count() here — any backend
    # query before initialize() permanently forecloses distributed init
    if jax.distributed.is_initialized():
        return
    kwargs = {}
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def make_global_mesh(model: int = 1) -> Mesh:
    """(data, model) mesh over ALL processes' devices, hosts-major.

    jax.devices() enumerates devices process-major, so reshaping to
    (n_global // model, model) puts the data axis across hosts first and
    keeps each model group inside one process — collectives of the SP
    paths never cross the network between hosts.  `model` must divide the
    per-process device count."""
    devs = jax.devices()
    per_proc = len(jax.local_devices())
    if per_proc % model != 0:
        raise ValueError(
            f"model={model} must divide local device count {per_proc}")
    arr = np.asarray(devs).reshape(len(devs) // model, model)
    return Mesh(arr, ("data", "model"))


def global_batch(mesh: Mesh, local_x: np.ndarray, pspec: P | None = None):
    """Assemble a global batch-sharded array from this process's local
    batch shard (every process calls this with its OWN rows; the global
    batch is the process-major concatenation).  `pspec` defaults to batch
    over every mesh axis (the DP layout); pass P('data', None) for inputs
    to the four-step SP pipelines."""
    if pspec is None:
        pspec = P(("data", "model"))
    sharding = NamedSharding(mesh, pspec)
    return jax.make_array_from_process_local_data(sharding, local_x)


def local_shard(z) -> np.ndarray:
    """This process's rows of a batch-sharded global result, as one numpy
    array (host-local; no cross-process traffic).  Requires the array to
    be sharded along axis 0 only (replicas allowed) — any non-leading-axis
    sharding raises instead of silently returning a partial slice."""
    shards = {}
    for s in z.addressable_shards:      # dedupe replicas (e.g. model axis)
        for dim, idx in enumerate(s.index[1:], start=1):
            if (idx.start or 0) != 0 or (idx.stop is not None
                                         and idx.stop != z.shape[dim]):
                raise ValueError(
                    f"local_shard expects batch-axis (axis 0) sharding "
                    f"only; got a shard split along axis {dim} "
                    f"(sharding {z.sharding})")
        shards.setdefault(s.index[0].start or 0, np.asarray(s.data))
    return np.concatenate([shards[k] for k in sorted(shards)], axis=0)


def barrier(name: str, timeout_s: float = 60.0) -> None:
    """Fail-fast cross-process rendezvous (explicit failure detection).

    Every process must reach the barrier within `timeout_s`, or the
    coordination service raises a timely error on every survivor — use it
    around collective sections so a dead or wedged peer surfaces as an
    exception instead of a cross-host all_to_all hanging forever.  The
    reference has no failure story at all (single-shot binary, SURVEY.md
    §5); this is the multi-host equivalent of its kernel-boundary sync.

    Recovery model (elastic, stateless): ALL device state in this
    framework is derived — parameter constants and twiddle/digit tables
    regenerate from (n, q) at trace time and there is nothing to
    checkpoint — so recovery from a detected failure is: tear down
    (jax.distributed.shutdown() or process exit), let the orchestrator
    re-launch on the surviving host set, re-run init_distributed with the
    new (num_processes, process_id), and recompute the in-flight batch.
    `barrier` is the detection half; the orchestrator owns the restart."""
    from jax._src import distributed as _dist
    client = _dist.global_state.client
    if client is None:      # single process: nothing to rendezvous with
        return
    client.wait_at_barrier(name, int(timeout_s * 1000))


def live_processes() -> list[int]:
    """Process ids the coordination service currently considers alive
    (heartbeat-based liveness, the service's failure detector).  Returns
    [0] when running single-process.  Survivors can use this after a
    barrier timeout to learn WHICH peer died before tearing down."""
    from jax._src import distributed as _dist
    client = _dist.global_state.client
    if client is None:
        return [0]
    live = client.get_live_nodes(list(range(jax.process_count())))
    return sorted(live)
