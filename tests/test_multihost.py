"""Emulated multi-host distribution test (SURVEY.md section 5.8).

Spawns 2 OS processes, each with 2 virtual CPU devices, joined through
jax.distributed with gloo CPU collectives - a stand-in for two hosts (the
gloo TCP link between processes, intra-process devices within each).
The production ShardedScanEngine must produce bit-identical candidate
streams through the 4-device global mesh.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_scan():
    port = _free_port()
    env = dict(os.environ)
    # workers manage their own device counts; drop the 8-device test flag
    env["XLA_FLAGS"] = env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=8", ""
    )
    repo = str(Path(__file__).parent.parent)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(port), str(pid), "2"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
    assert "bit-identical OK" in outs[0]
    assert "bit-identical OK" in outs[1]
    # scaling estimator numbers must be reported by both workers (the cross-host
    # payload anchor for the docs/design.md cost model)
    import re

    for out in outs:
        m = re.search(r"estimator pass_s=([\d.]+) allgather_bytes=(\d+) bytes_per_bp=([\d.]+)", out)
        assert m, f"estimator line missing:\n{out}"
        # the bitmap payload is ~1/block bytes per bp (block=512): tiny vs
        # any plausible host-to-host bandwidth, which is what makes >=80% scaling
        # efficiency expected - see docs/design.md
        assert float(m.group(3)) < 0.02
