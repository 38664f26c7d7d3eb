"""Device-mesh construction for the sharded scan, single- and multi-host.

The framework's parallelism axes (SURVEY.md section 2.2):
  * ``data``  - genome tiles sharded along the sequence axis (the
    context-parallel analogue: overlapped tiling makes tiles independent,
    section 5.7);
  * ``clusters`` - cluster-mode profiles sharded "one expert per reference
    cluster" (the EP analogue).

Profiles are replicated; per-shard fixed-capacity bitmap/candidate buffers
are combined with all_gather.  Multi-host (the distribution layer the
reference lacks - its only parallelism is the disabled thread fan-out,
ref KmerGMA.jl/src/MultiThread/GenomeMiner.jl:101-145):
``initialize_distributed`` wires up jax.distributed, and ``make_mesh``
then lays the ``data`` axis out host-outer x local-device-inner, so the
halo-free span scan communicates nothing host-to-host except the tiny
bitmap all_gather, once per record.  Tested by a 2-process CPU-gloo harness
(tests/test_multihost.py).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialise jax.distributed for multi-host meshes (idempotent).

    Pass the coordinator address, process count and process id
    explicitly; on CPU (emulated multi-host tests) also set
    ``jax_cpu_collectives_implementation='gloo'`` before calling.
    """
    if jax.distributed.is_initialized():
        return  # idempotent (process_count() would itself init the backend)
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def _cluster_ways(n_clusters: int, n_devices: int) -> int:
    for cand in range(min(n_clusters, n_devices), 0, -1):
        if n_devices % cand == 0:
            return cand
    return 1


def make_mesh(n_devices: int | None = None, n_clusters: int = 1) -> Mesh:
    """A ("clusters", "data") mesh over the first ``n_devices`` devices.

    The clusters axis gets min(n_clusters, largest divisor) ways; the rest
    goes to data parallelism.  With multiple processes (after
    ``initialize_distributed``) the mesh spans ALL hosts' devices with the
    data axis host-outer x local-device-inner - process boundaries land on
    the slowest-varying mesh dimension, so intra-span traffic never crosses
    hosts.
    """
    if jax.process_count() > 1 and n_devices is None:
        return make_hybrid_mesh(n_clusters=n_clusters)
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    devs = devs[:n_devices]
    c = _cluster_ways(n_clusters, n_devices)
    return Mesh(np.asarray(devs).reshape(c, n_devices // c), axis_names=("clusters", "data"))


def make_hybrid_mesh(n_clusters: int = 1) -> Mesh:
    """A ("clusters", "data") mesh over every process's devices, laid out
    process-outer x local-device-inner on the data axis.

    The clusters axis stays within a process (profiles are small and the
    cluster merge is latency-sensitive); the data axis crosses hosts, where
    the only collective is the per-record bitmap all_gather.  Built by hand
    from jax.devices() order (process-major), which puts process boundaries
    on the slowest-varying data positions.
    """
    n_local = jax.local_device_count()
    n_proc = jax.process_count()
    c = _cluster_ways(n_clusters, n_local)
    # (proc, clusters, data_local) -> (clusters, proc * data_local)
    arr = np.asarray(jax.devices()).reshape(n_proc, c, n_local // c)
    arr = np.moveaxis(arr, 1, 0).reshape(c, n_proc * (n_local // c))
    return Mesh(arr, axis_names=("clusters", "data"))
