"""Device-side batched semi-global alignment (SURVEY section 7 item 5's
"batched alignment stage", built as jitted XLA: the DP is a 290-step
lax.scan of tiny (B, n) integer rows - latency-, not compute-bound - and
the traceback a vmapped while_loop over CIGAR *runs*, not cells).

Bit-identical to ops/align.semiglobal_align (fuzz-pinned): the forward
recurrence is the same int32 arithmetic (cummax running-max F), and the
traceback reproduces _traceback's branch structure - endpoint = LAST
argmax of H[m], match > D > I at ties, extend-over-open inside gaps.
All comparisons are integer, so device/host equality is structural, not
numerical.

Traceback by runs: a per-cell traceback walks one CELL per while_loop
iteration (~m+n latency-bound steps of scattered gathers).  The
forward scan now also computes, per cell, the decision the traceback
would take there AND the full run length of that decision:

  * C[i,j]  - maximal diagonal chain: diag_ok ? 1 + C[i-1,j-1] : 0,
  * FL[i,j] - subject-gap run:  ext_f ? FL[i,j-1] + 1 : 1,
  * EL[i,j] - query-gap run:    ext_e ? EL[i-1,j] + 1 : 1,

packed as TL[i,j] = (runlen << 2) | op.  These recurrences are exactly
the traceback's own state machine unrolled (from_f/from_e chain while the
extend equality holds; from_h re-evaluates after every diagonal step), so
jumping a whole run per iteration emits the identical op sequence.  The
while_loop now runs ~#CIGAR-runs iterations (typically < 10) with ONE
gather per iteration, and only H's last row + TL survive the forward
pass (H/E/F no longer materialise).  Host code expands diagonal runs to
=/X per cell (it has both sequences) and reverses into runs - identical
AlignResults.  Hits whose run count overflows the fixed buffer (RLE_CAP;
structurally impossible for real hits, which are near-identical matches)
fall back to the host oracle aligner.
"""

from __future__ import annotations

from functools import partial

import numpy as np

from .align import _NUC44, AlignResult, _seq_to_idx, semiglobal_align

_OPS = "=XID"
NEG = -(2**30)
RLE_CAP = 256  # max CIGAR runs per hit on the device path (bench-shaped
# hits - a consensus vs a DIFFERENT family member - measured up to ~117
# runs; 96 silently sent ~20% of hits to the host fallback)


def _forward_tl(a_sub, bmat, go, ge):
    """Forward DP emitting the packed traceback run matrix.

    a_sub: int32[m, 15] = NUC44 rows of the query letters.
    bmat: int32[B, n] subject letter indices.
    Returns (H_last int32[B, n+1], TL int32[m, B, n+1]).
    """
    import jax
    import jax.numpy as jnp

    m = a_sub.shape[0]
    B, n = bmat.shape
    # substitution rows via a one-hot matmul (a 15-entry gather per cell is
    # slow); HIGHEST precision keeps it exact (no TF32 rounding of the
    # small-integer scores)
    oh = (bmat[:, :, None] == jnp.arange(15, dtype=jnp.int32)[None, None, :]).astype(
        jnp.float32
    )  # (B, n, 15)
    subs = jnp.einsum(
        "mk,bnk->mbn", a_sub.astype(jnp.float32), oh,
        precision=jax.lax.Precision.HIGHEST,
    ).astype(jnp.int32)  # (m, B, n), exact: one-hot selects single entries

    jj = jnp.arange(1, n + 1, dtype=jnp.int32)
    jpos = jnp.arange(n + 1, dtype=jnp.int32)[None, :]  # column index grid
    H0 = jnp.zeros((B, n + 1), dtype=jnp.int32)
    E0 = jnp.full((B, n + 1), NEG, dtype=jnp.int32)
    C0 = jnp.zeros((B, n + 1), dtype=jnp.int32)
    EL0 = jnp.zeros((B, n + 1), dtype=jnp.int32)

    def step(carry, xs):
        H_prev, E_prev, C_prev, EL_prev = carry
        sub_i, i = xs
        col = go + ge * i  # H[i,0] = E[i,0]
        E_i1 = jnp.maximum(H_prev[:, 1:] + (go + ge), E_prev[:, 1:] + ge)
        diag = H_prev[:, :-1] + sub_i
        G = jnp.maximum(diag, E_i1)
        base = jnp.concatenate(
            [jnp.full((B, 1), col, dtype=jnp.int32), G - ge * jj[None, :]], axis=1
        )
        run = jax.lax.cummax(base[:, :-1], axis=1)
        F_i1 = (go + ge * jj[None, :]) + run
        H_i1 = jnp.maximum(G, F_i1)
        H_i = jnp.concatenate([jnp.full((B, 1), col, dtype=jnp.int32), H_i1], axis=1)
        E_i = jnp.concatenate([jnp.full((B, 1), col, dtype=jnp.int32), E_i1], axis=1)
        F_i = jnp.concatenate([jnp.full((B, 1), NEG, dtype=jnp.int32), F_i1], axis=1)

        # traceback decisions + run lengths at every cell of row i
        sub_row = jnp.concatenate(
            [jnp.zeros((B, 1), dtype=jnp.int32), sub_i], axis=1
        )  # sub at (i, j) lives at column j-1; pad col 0 (never used: j>0)
        diag_ok = (jpos > 0) & (
            H_i == jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32), H_prev[:, :-1]], axis=1) + sub_row
        )
        f_ok = (jpos > 0) & (H_i == F_i)
        # C: diagonal chain against row i-1 shifted one left
        C_shift = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), C_prev[:, :-1]], axis=1)
        C_i = jnp.where(diag_ok, C_shift + 1, 0)
        # EL: query-gap chain straight up
        ext_e = (i > 1) & (E_i == E_prev + ge)
        EL_i = jnp.where(ext_e, EL_prev + 1, 1)
        # FL: subject-gap chain along the row (run length since last break)
        ext_f = (jpos > 1) & (F_i == jnp.concatenate([jnp.full((B, 1), NEG, jnp.int32), F_i[:, :-1]], axis=1) + ge)
        brk = jnp.where(ext_f, jnp.int32(-1), jpos)
        last_brk = jax.lax.cummax(jnp.broadcast_to(brk, F_i.shape), axis=1)
        FL_i = jpos - last_brk + 1
        TL_i = jnp.where(
            diag_ok, (C_i << 2),
            jnp.where(f_ok, (FL_i << 2) | 3, (EL_i << 2) | 2),
        )
        return (H_i, E_i, C_i, EL_i), TL_i

    iis = jnp.arange(1, m + 1, dtype=jnp.int32)
    (H_last, _, _, _), TL = jax.lax.scan(step, (H0, E0, C0, EL0), (subs, iis))
    return H_last, TL


def _traceback_rle_one(TL1, j0, m, n):
    """Run-length traceback for ONE hit from the packed TL matrix.

    TL1: int32[m, n+1] (row index i-1 holds query row i).  Returns
    (rle int32[RLE_CAP], n_runs, j_f): rle entries are (len << 2) | op in
    traceback (reverse) order, entry 0 the trailing free-subject-gap run.
    """
    import jax
    import jax.numpy as jnp

    lead = (n - j0).astype(jnp.int32)
    rle0 = jnp.zeros(RLE_CAP, dtype=jnp.int32)
    rle0 = rle0.at[0].set((lead << 2) | 3)
    pos0 = (lead > 0).astype(jnp.int32)

    def cond(c):
        i, j, pos, rle = c
        return i > 0

    def body(c):
        i, j, pos, rle = c
        v = jax.lax.dynamic_index_in_dim(
            jax.lax.dynamic_index_in_dim(TL1, i - 1, 0, keepdims=False),
            j, 0, keepdims=False,
        )
        t = v >> 2
        op = v & 3
        rle = rle.at[jnp.minimum(pos, RLE_CAP - 1)].set(v)
        di = jnp.where(op == 3, 0, t)
        dj = jnp.where(op == 2, 0, t)
        return i - di, j - dj, pos + 1, rle

    _, j_f, pos_f, rle_f = jax.lax.while_loop(
        cond, body, (jnp.int32(m), j0, pos0, rle0)
    )
    return rle_f, pos_f, j_f


_fwd_tb_jit = None


def _get_jit():
    global _fwd_tb_jit
    if _fwd_tb_jit is not None:
        return _fwd_tb_jit
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnames=("m", "n", "go", "ge"))
    def run(a_sub, bmat, *, m, n, go, ge):
        H_last, TL = _forward_tl(a_sub, bmat, jnp.int32(go), jnp.int32(ge))
        scores = jnp.max(H_last, axis=1)
        # endpoint: LAST column attaining the max
        j0s = (n - jnp.argmax(H_last[:, ::-1], axis=1)).astype(jnp.int32)

        def one(TL1, j0):
            return _traceback_rle_one(TL1, j0, m, n)

        # vmap over the BATCH axis in place (axis 1 of the row-major TL) -
        # materialising (B, m, n+1) transposes relayouts ~45 MB for nothing
        rle, n_runs, j_f = jax.vmap(one, in_axes=(1, 0))(TL, j0s)
        return scores, rle, n_runs, j0s

    _fwd_tb_jit = run
    return run


def _decode_rle(entries, m, n, a_np, b_np):
    """Expand device RLE runs (traceback order) into AlignResult cigar
    runs - identical to a per-cell decode: per-cell codes in
    traceback order + leading free-gap Ds, reversed and merged.  The walk
    starts at (m, n); the trailing free-gap run (entry 0 when j0 < n) is
    an ordinary D run that brings j to the alignment endpoint."""
    cells = []
    i, j = m, n
    for v in entries:
        t, op = int(v) >> 2, int(v) & 3
        if op == 0:
            eq = (a_np[i - t : i] == b_np[j - t : j])[::-1]
            cells.append(np.where(eq, 0, 1).astype(np.int8))
            i -= t
            j -= t
        elif op == 3:
            cells.append(np.full(t, 3, dtype=np.int8))
            j -= t
        else:
            cells.append(np.full(t, 2, dtype=np.int8))
            i -= t
    cells.append(np.full(j, 3, dtype=np.int8))  # leading free subject gap
    full = np.concatenate(cells) if cells else np.zeros(0, dtype=np.int8)
    runs: list[tuple[int, str]] = []
    for op_code in full[::-1]:
        op = _OPS[int(op_code)]
        if runs and runs[-1][1] == op:
            runs[-1] = (runs[-1][0] + 1, op)
        else:
            runs.append((1, op))
    return runs


def semiglobal_align_device(
    query: "str | bytes",
    subjects: "list[str | bytes]",
    gap_open: int = -69,
    gap_extend: int = -1,
) -> "list[AlignResult]":
    """Device-batched semiglobal_align: bit-identical results."""
    if not subjects:
        return []
    import jax.numpy as jnp

    a = _seq_to_idx(query)
    bs = [_seq_to_idx(s) for s in subjects]
    m = a.shape[0]
    a_sub = jnp.asarray(_NUC44[a].astype(np.int32))
    a_np = a.astype(np.int32)
    out: list[AlignResult | None] = [None] * len(subjects)

    by_len: dict[int, list[int]] = {}
    for i, b in enumerate(bs):
        by_len.setdefault(b.shape[0], []).append(i)
    run = _get_jit()
    for n, idxs in by_len.items():
        bmat = np.stack([bs[i] for i in idxs]).astype(np.int32)
        scores, rle, n_runs, j0s = (
            np.asarray(x)
            for x in run(a_sub, jnp.asarray(bmat), m=m, n=n,
                         go=int(gap_open), ge=int(gap_extend))
        )
        overflowed: list[int] = []
        for bi, i_orig in enumerate(idxs):
            if int(n_runs[bi]) > RLE_CAP:
                overflowed.append(i_orig)
                continue
            entries = rle[bi, : int(n_runs[bi])]
            runs = _decode_rle(entries, m, n, a_np, bmat[bi])
            out[i_orig] = AlignResult(score=int(scores[bi]), cigar_runs=runs)
        if overflowed:
            # run-count overflow (structurally pathological): ONE batched
            # exact host-oracle pass for all such hits
            from .align import semiglobal_align_batch

            redo = semiglobal_align_batch(
                query, [subjects[i] for i in overflowed], gap_open, gap_extend
            )
            for i_orig, r in zip(overflowed, redo):
                out[i_orig] = r
    return out  # type: ignore[return-value]
