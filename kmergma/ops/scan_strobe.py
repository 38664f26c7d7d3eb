"""Device-side strobemer scan distances.

The reference's StrobeGMA recomputes boundary strobemers per position and
carries a float spectrum/distance sequentially
(ref KmerGMA.jl/src/StrobemerGMA/StrobeGenomeMiner.jl:48-67).  Its
rolling spectrum is NOT a clean sliding window: the right-boundary anchor
is off by one (seq[i+ws-k] instead of i+ws-k+1), so the evolving counts
drift from the true window spectrum.  Analysis of the recurrence shows the
drift has closed form: with K = per-position strobemer codes and
W = ws - k (one less than the true window k-mer count),

    c_j = slidingcount(K, [j+1, j+W]) + onehot(K[W'])        (0-based x* = K[ws-k])

i.e. the counts equal a width-W sliding count PLUS one persistent extra
count of the fixed code x* = the strobemer anchored at position ws-k+1
(1-based) - the element the buggy first step double-adds and never fully
removes.  That makes the whole scan expressible with the SAME
de-sequentialised machinery as the k-mer scan (ops/scan.py): fixed-lag
match counts + an elementwise x*-correction + one cumsum, in exact scaled
integers.  This module implements that, bit-matching the reference
recurrence (cross-validated against the sequential implementation in
tests/test_strobe_scan.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("w", "r", "n_steps"))
def strobe_scan_from_codes(kcodes, s_profile, w: int, r: int, n_steps: int):
    """Exact scaled distances D[j], j = 0..n_steps, of the StrobeGMA
    recurrence over precomputed strobemer codes.

    kcodes: int32[M] strobemer code at each 0-based position (M >= n_steps + w + 1).
    s_profile: int32[4^(2s)] integer summed reference strobe spectrum.
    w: ws - k (the reference's effective rolling width).
    Returns int32[n_steps + 1]; true distance = D / (2 k_eff r^2) with
    k_eff = w_max + s - 1.
    """
    g = jnp.take(s_profile, kcodes)

    # init spectrum counts K[0..w] - w+1 elements (the reference counts all
    # strobemers of seq[1:ws], one more than the rolling width)
    c0 = jax.ops.segment_sum(
        jnp.ones(w + 1, dtype=jnp.int32), kcodes[: w + 1], num_segments=s_profile.shape[0]
    )
    diff0 = r * c0 - s_profile
    d0 = jnp.sum(diff0 * diff0)
    if n_steps < 1:
        return d0[None]

    xstar = kcodes[w]  # the persistently double-counted code
    kl = kcodes[:n_steps]  # L_j = K[j-1]       (j = 1..n_steps)
    kr = kcodes[w : w + n_steps]  # R_j = K[j-1+w]

    def body(d, ab):
        a, b = ab
        a = a + (jax.lax.dynamic_slice(kcodes, (w - d,), (n_steps,)) == kr)
        b = b + (jax.lax.dynamic_slice(kcodes, (d - 1,), (n_steps,)) == kl)
        return a, b

    zero = jnp.zeros_like(kl)
    a, b = jax.lax.fori_loop(1, w + 1, body, (zero, zero))
    # x*-correction: c_{j-1}[R_j] gains [R_j == x*], c_{j-1}[L_j] gains [L_j == x*]
    a = a + (kr == xstar).astype(jnp.int32)
    b = b + (kl == xstar).astype(jnp.int32)

    r2 = jnp.int32(2 * r * r)
    delta = r2 * (kl != kr) + r2 * (a - b) + (2 * r) * (g[:n_steps] - g[w : w + n_steps])
    return jnp.concatenate([d0[None], d0 + jnp.cumsum(delta)])


def strobe_scan_distances_np(codes: np.ndarray, s_profile: np.ndarray, s: int, w_min: int, w_max: int, q: int, ws: int, r: int) -> np.ndarray:
    """Sequential oracle: the reference recurrence verbatim in scaled
    integers (for validation)."""
    from .strobemers import strobe_2_mer_codes

    k = w_max + s - 1
    sc = strobe_2_mer_codes(codes, s, w_min, w_max, q)
    n = codes.shape[0]
    n_steps = n - ws - 1
    nbins = s_profile.shape[0]
    c = np.bincount(sc[: ws - k + 1], minlength=nbins).astype(np.int64)
    s64 = s_profile.astype(np.int64)
    diff = r * c - s64
    out = np.empty(n_steps + 1, dtype=np.int64)
    out[0] = np.dot(diff, diff)
    d = out[0]
    w = ws - k
    for i in range(1, n_steps + 1):
        li = sc[i - 1]
        ri = sc[i - 1 + w]
        if li != ri:
            d += 2 * r * r * (c[ri] - c[li]) + 2 * r * (s64[li] - s64[ri]) + 2 * r * r
            c[li] -= 1
            c[ri] += 1
        out[i] = d
    return out
