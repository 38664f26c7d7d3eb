"""Sequential minima/dedupe state machines, replayed exactly on host.

The scan's distance values are embarrassingly parallel (ops/scan.py), but the
reference's minima tracking (currminim/CMI/stop/goal_ind,
ref KmerGMA.jl/src/GenomeMiner.jl:57,82-104) and cluster-mode overlap
suppression (prev_hit_range, ref OmnGenomeMiner.jl:122-155) are
order-dependent.  Per SURVEY.md section 7 hard-part 1, the device emits the
*sparse* stream of windows that can influence the state machine (windows
below threshold, plus the window immediately after each - the rising edges),
and this module replays the exact sequential semantics over that stream -
exactness by construction, at a cost proportional to the (tiny) number of
candidate windows, not the genome length.

Index conventions: window j (0-based start j... reported 1-based as the
j-th iterative window) covers sequence positions [j+1, ws+j] 1-based =
Julia's window after iterative step j; j=0 is the init window [1, ws].  The
single-profile miner's CMI for window j is i_left = k + j - 1
(GenomeMiner.jl:85); the cluster miner's CMI is j itself
(OmnGenomeMiner.jl:117).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

import numpy as np


@dataclass
class RawHit:
    """A candidate hit before alignment/trimming."""

    cmi: int  # the reference's post-increment CMI (1-based sequence coord)
    dist: float  # currminim at emission (exact)
    start: int  # 1-based inclusive buffered range start
    stop: int  # 1-based inclusive buffered range end


def candidate_stream_from_dists(dists: np.ndarray, thr: float) -> Iterator[tuple[int, float]]:
    """(window index, value) pairs for windows with d < thr plus each rising
    edge, from a full window-distance array (index 0 = init window, not
    iterated - matches the reference's iterative phase starting after init)."""
    below = dists < thr
    mask = below.copy()
    mask[1:] |= below[:-1]
    mask[0] = False
    for j in np.nonzero(mask)[0]:
        yield int(j), float(dists[j])


def replay_single_seq(
    stream: Iterable[tuple[int, float]],
    dist0: float,
    thr: float,
    k: int,
    ws: int,
    seq_len: int,
    buff: int,
    cmi_offset: int | None = None,
) -> list[RawHit]:
    """Element-by-element replay of the single-profile minima machine
    (ref GenomeMiner.jl:57-104) - the semantic oracle for replay_single.

    ``stream`` must yield (j, d) sorted by j for every window with d < thr
    and every rising-edge window; other windows cannot change the state.
    ``cmi_offset`` maps the window index j to the recorded CMI: the k-mer
    miner uses i_left = j + k - 1 (the default); the strobemer miner uses
    the raw step index j (StrobeGenomeMiner.jl:75 -> cmi_offset=0).
    """
    if cmi_offset is None:
        cmi_offset = k - 1
    hits: list[RawHit] = []
    currminim = dist0
    cmi, stop, goal_ind = 2, True, 0

    for j, d in stream:
        if d < thr:
            if d < currminim:
                currminim = d
                cmi = j + cmi_offset
                stop = False
        elif not stop:
            stop = True
            cmi += 1
            if cmi > goal_ind:
                goal_ind = cmi + ws - 1
                start = max(cmi - buff, 1)
                end = min(cmi + ws - 1 + buff, seq_len)
                hits.append(RawHit(cmi=cmi, dist=currminim, start=start, stop=end))
                currminim = d
    return hits


def replay_single(
    stream: Iterable[tuple[int, float]],
    dist0: float,
    thr: float,
    k: int,
    ws: int,
    seq_len: int,
    buff: int,
    cmi_offset: int | None = None,
) -> list[RawHit]:
    """Run-segmented replay: identical outputs to replay_single_seq at a
    cost proportional to the number of BELOW-RUNS (~hits), not stream
    elements (the hit-dense 64 Mbp bench carries ~51k candidates; the
    per-element Python loop was the single most expensive stage at ~0.8 s).

    Within one maximal below-threshold run the machine's net effect is
    closed-form: the prefix-minimum's LAST strict decrease happens at the
    FIRST attainment of the run minimum, so if min(run) < currminim the run
    sets (currminim, cmi) to that (value, position) and opens ``stop``;
    otherwise it leaves the state untouched.  The next stream element after
    a run (>= thr by maximality, exactly like the sequential loop - run
    boundaries follow stream ORDER, not index adjacency) performs the edge
    processing verbatim.  Exact equivalence is fuzz-pinned against
    replay_single_seq in tests/test_state_machine.py.
    """
    if cmi_offset is None:
        cmi_offset = k - 1
    data = stream if isinstance(stream, list) else list(stream)
    if not data:
        return []
    idx = np.fromiter((j for j, _ in data), dtype=np.int64, count=len(data))
    vals = np.fromiter((d for _, d in data), dtype=np.float64, count=len(data))
    below = vals < thr
    n = below.size
    run_starts = np.nonzero(below & ~np.concatenate(([False], below[:-1])))[0]
    run_ends = np.nonzero(below & ~np.concatenate((below[1:], [False])))[0]

    hits: list[RawHit] = []
    currminim = dist0
    cmi, goal_ind = 2, 0
    for s, e in zip(run_starts, run_ends):
        seg = vals[s : e + 1]
        i_rel = int(np.argmin(seg))
        v = float(seg[i_rel])
        if not v < currminim:
            continue  # no update in this run -> stop stays True, edge no-ops
        currminim = v
        cmi = int(idx[s + i_rel]) + cmi_offset
        # stop is now False; the edge (next element, >= thr) processes it
        if e + 1 < n:
            cmi += 1
            if cmi > goal_ind:
                goal_ind = cmi + ws - 1
                start = max(cmi - buff, 1)
                end = min(cmi + ws - 1 + buff, seq_len)
                hits.append(RawHit(cmi=cmi, dist=currminim, start=start, stop=end))
                currminim = float(vals[e + 1])
    return hits


@dataclass
class OmnHitEvent:
    """A cluster-mode rising-edge event, pre-overlap-checks."""

    cluster: int  # 0-based cluster index
    cmi: int  # the raw i value (1-based window index)
    dist: float  # curr_mins at emission
    edge_dist: float  # distance at the rising edge (resets curr_mins on accept)


def replay_omn(
    streams: list[list[tuple[int, float]]],
    dist0s: list[float],
    thr_vec: list[float],
    k: int,
    windowsizes: list[int],
    seq_len: int,
    process: Callable[[OmnHitEvent], bool],
) -> None:
    """Exact replay of the cluster-mode machine (ref OmnGenomeMiner.jl:61-157).

    The reference's main loop iterates i = 1 .. seq_len - max(ws) - k + 2
    with ALL clusters advanced in cluster order at each i (the inner
    ``for ind in 1:len_KFVs``); we merge the per-cluster sparse streams in
    (i, cluster) order so cross-cluster overlap suppression sees events in
    the exact same order.  ``process`` performs the overlap checks +
    alignment + append and returns True iff the hit was accepted (which
    resets that cluster's curr_mins to the edge distance,
    OmnGenomeMiner.jl:153).  Rejected hits do NOT reset curr_mins.

    Stays element-by-element (unlike replay_single's run segmentation):
    acceptance feeds back into per-cluster state, so runs cannot be
    pre-collapsed without replicating the process() decision - and the
    measured cost is small (34 ms for 185k merged events at m=6, ~7% of a
    cluster record; revisit only if multi-Gbp cluster replays dominate).

    Streams must already be bounded to i <= imax = seq_len - max(ws) - k + 2.
    """
    m = len(streams)
    maxws = max(windowsizes)
    imax = seq_len - maxws - k + 2
    if imax < 1:
        return

    curr_mins = list(dist0s)
    cmis = [1] * m
    stops = [True] * m

    merged: list[tuple[int, int, float]] = []
    for ind in range(m):
        for i, d in streams[ind]:
            if i <= imax:
                merged.append((i, ind, d))
    merged.sort()

    for i, ind, d in merged:
        if d < thr_vec[ind]:
            if d < curr_mins[ind]:
                curr_mins[ind] = d
                cmis[ind] = i
                stops[ind] = False
        elif not stops[ind]:
            stops[ind] = True
            accepted = process(
                OmnHitEvent(cluster=ind, cmi=cmis[ind], dist=curr_mins[ind], edge_dist=d)
            )
            if accepted:
                curr_mins[ind] = d
