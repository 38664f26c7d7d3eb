"""Per-backend engine defaults and the compile-cache rule.

Every default that depends on the JAX backend is read from ``policy()``;
nothing else in the package asks which backend it runs on.  A backend
without an entry raises instead of silently taking another backend's
settings.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import jax


@dataclass(frozen=True)
class BackendPolicy:
    #: windows per span of the bitmap pass (one ``lax.scan`` step)
    span_windows: int
    #: strobemer codes are extracted on the device (genome codes cross the
    #: link 2-bit packed) rather than on the host
    device_strobe_extract: bool
    #: the batch aligner routes to the device DP (ops/align_device.py)
    #: when the native host DP is unavailable
    device_align: bool


_POLICIES = {
    # span size chosen by the sweep in chip_smoke.py (PERF.md, "Bring-up
    # findings"); device extraction keeps the strobemer path on the card
    "gpu": BackendPolicy(span_windows=1 << 22, device_strobe_extract=True, device_align=False),
    # CPU: the test backend; modest spans bound host memory
    "cpu": BackendPolicy(span_windows=1 << 19, device_strobe_extract=False, device_align=False),
}


def policy(backend: str | None = None) -> BackendPolicy:
    """The engine defaults for ``backend`` (default: JAX's default backend)."""
    name = jax.default_backend() if backend is None else backend
    try:
        return _POLICIES[name]
    except KeyError:
        raise RuntimeError(
            f"no engine policy for JAX backend {name!r} (supported: "
            f"{', '.join(sorted(_POLICIES))})"
        ) from None


#: persistent compile cache used when JAX_COMPILATION_CACHE_DIR is unset:
#: a fixed path inside the checkout (the path is part of the cache key)
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def ensure_compile_cache() -> None:
    """Turn on JAX's persistent compilation cache.

    If ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads it itself) or the
    caller configured a directory, nothing is set here; otherwise the cache
    lives at ``CACHE_DIR``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") or jax.config.jax_compilation_cache_dir:
        return
    os.makedirs(CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
