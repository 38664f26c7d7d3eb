"""The backend policy (one table of per-backend engine defaults) and the
persistent compile-cache rule (kmergma/backend.py)."""

import os

import jax
import numpy as np
import pytest

from kmergma import backend


def test_policy_gpu_values():
    p = backend.policy("gpu")
    assert p.span_windows == 1 << 22
    assert p.device_strobe_extract is True
    assert p.device_align is False


def test_policy_cpu_values():
    p = backend.policy("cpu")
    assert p.span_windows == 1 << 19
    assert p.device_strobe_extract is False
    assert p.device_align is False


def test_policy_defaults_to_the_running_backend():
    assert backend.policy() == backend.policy(jax.default_backend())


@pytest.mark.parametrize("name", ["rocm", "metal", "neuron"])
def test_policy_unknown_backend_raises(name):
    with pytest.raises(RuntimeError, match=repr(name)):
        backend.policy(name)


def test_engine_refuses_unknown_backend(monkeypatch):
    """No engine falls through to another backend's defaults."""
    from kmergma.ops.scan import ScanEngine

    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="rocm"):
        ScanEngine(np.ones(4**4, np.int64), k=4, ws=40, r=1)
    # an explicit span needs no policy
    eng = ScanEngine(np.ones(4**4, np.int64), k=4, ws=40, r=1, chunk_windows=1024)
    assert eng.chunk == 1024


@pytest.mark.parametrize("device_align", [False, True])
def test_aligner_routing_follows_policy(monkeypatch, device_align):
    """Without the native DP, the policy decides whether hit batches go to
    the device aligner; both routes give identical alignments."""
    import dataclasses

    from kmergma.ops import align, align_device

    cpu = backend.policy("cpu")
    monkeypatch.setitem(
        backend._POLICIES, "cpu", dataclasses.replace(cpu, device_align=device_align)
    )
    monkeypatch.setenv("KMERGMA_ALIGN_NATIVE", "0")
    calls = []
    real = align_device.semiglobal_align_device

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(align_device, "semiglobal_align_device", spy)
    rng = np.random.default_rng(2)
    query = "".join("ACGT"[i] for i in rng.integers(0, 4, 60))
    subjects = [query[5:55] + "".join("ACGT"[i] for i in rng.integers(0, 4, 8)) for _ in range(16)]
    got = align.align_hits_batch(query, subjects)
    assert bool(calls) == device_align
    want = align.semiglobal_align_batch(query, subjects, -69, -1)
    assert [(a.score, a.cigar_runs) for a in got] == [(a.score, a.cigar_runs) for a in want]


def _recording_update(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda name, value: calls.append((name, value)))
    return calls


def test_cache_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _recording_update(monkeypatch)
    backend.ensure_compile_cache()
    assert calls == []  # JAX reads the variable itself; nothing is set in code


def test_cache_defaults_to_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", None)
    try:
        calls = _recording_update(monkeypatch)
        backend.ensure_compile_cache()
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", prev)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert backend.CACHE_DIR == os.path.join(repo, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", backend.CACHE_DIR)]


def test_cache_keeps_a_configured_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    try:
        calls = _recording_update(monkeypatch)
        backend.ensure_compile_cache()
    finally:
        monkeypatch.undo()
        jax.config.update("jax_compilation_cache_dir", prev)
    assert calls == []
