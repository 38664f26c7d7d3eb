"""Worker for the emulated multi-host test (tests/test_multihost.py).

Runs as `python multihost_worker.py <port> <process_id> <num_processes>`:
forces 2 virtual CPU devices, joins a gloo-backed jax.distributed cluster,
builds the host-outer hybrid mesh via make_mesh, runs the production
ShardedScanEngine over the global mesh, and asserts its candidate stream is
bit-identical to the single-device ScanEngine on the same record.
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main() -> None:
    port, pid, nproc = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])

    from kmergma.parallel.mesh import initialize_distributed, make_mesh

    initialize_distributed(f"127.0.0.1:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc

    import numpy as np

    from kmergma.ops.scan import ScanEngine
    from kmergma.parallel.sharded_scan import ShardedScanEngine

    mesh = make_mesh()  # auto-detects multi-process -> hybrid host-outer mesh
    assert mesh.shape["data"] == 2 * nproc, dict(mesh.shape)
    # process boundaries must land on the outer data dimension
    procs = [d.process_index for d in mesh.devices.reshape(-1)]
    assert procs == sorted(procs), procs

    rng = np.random.default_rng(3)
    n, k, ws, r = 30000, 6, 289, 9
    codes = rng.integers(0, 4, n, dtype=np.int8)
    s = rng.integers(0, 10, 4**k).astype(np.int32)

    single = ScanEngine(s, k=k, ws=ws, r=r, chunk_windows=2048)
    _, probe, _ = single.record_stream(codes, thr=1e9)
    thr = float(np.percentile(np.array([v for _, v in probe]), 5))
    d0_a, stream_a, _ = single.record_stream(codes, thr)

    sharded = ShardedScanEngine(s, k=k, ws=ws, r=r, mesh=mesh, chunk_windows=2048)
    d0_b, stream_b, _ = sharded.record_stream(codes, thr)

    assert d0_a == d0_b
    assert stream_a == stream_b
    print(f"proc {pid}: multihost sharded stream bit-identical OK", flush=True)

    # ---- scaling estimator (SURVEY.md 5.8, BASELINE >=80% @ N>=2 hosts) ----
    # The only cross-host traffic in a sharded scan is the bitmap all_gather
    # (active regions are host-fetched per process).  Measure the payload
    # and the per-process pass time so the cross-host cost model in docs/design.md
    # is anchored to observed numbers.
    import time

    span, block = sharded.chunk, sharded.block
    nw = n - ws + 1
    n_spans = -(-nw // span)
    from kmergma.ops.scan import _span_bucket

    spd = _span_bucket(max(1, -(-n_spans // mesh.shape["data"])))
    blocks_total = mesh.shape["data"] * spd * (span // block)
    gather_bytes = blocks_total  # bool per block crosses hosts once per device
    # per-record payload model: G/block bools per record, independent of N
    assert blocks_total * block >= nw

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        sharded.record_stream(codes, thr)
        best = min(best, time.perf_counter() - t0)
    print(
        f"proc {pid}: estimator pass_s={best:.4f} allgather_bytes={gather_bytes} "
        f"bytes_per_bp={gather_bytes/n:.5f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
