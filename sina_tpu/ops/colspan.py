"""Query column-span anchoring for profile-DP trimming.

Amplicon queries (~250 nt) align into a small window of the family
profile, but the DP lattice is sized to the family's full occupied
column count (C ~ 1530 for full-length rRNA): ~8x the needed work for
a V4 window.  This module estimates, per query, the occupied-column
window that must contain its alignment, so the dispatcher can slice
the profile and run the DP on the window only.

The reference has no equivalent (its per-sequence CPU DP pays the
full lattice every time); this is a throughput lever and
must be *conservative*: a window that clips the true optimum changes
results, so estimates derive from exact k-mer anchors against the
family's top reference with generous indel slack, and callers fall
back to the full lattice whenever anchoring looks weak (too few
anchors, inconsistent diagonals).

All numpy, vectorised; the per-family k-mer table is built once and
shared by every query aligned against that family.
"""

from __future__ import annotations

import numpy as np

from .. import alphabet

_K = 12
# minimum consistent anchors before we trust a window
_MIN_ANCHORS = 3
# diagonal-consistency gate: |offset - median| beyond this marks a
# spurious k-mer hit (repeats); budget scales with query length
_DIAG_SLACK_FRAC = 0.25
_DIAG_SLACK_MIN = 100
# occurrences considered per matched k-mer (repeat tolerance)
_MAX_OCC = 4
# the dispatcher snaps window starts down to this occupied-column
# rank grid; _trim_windows adds the same amount to the size estimate
# (keep the two coupled — see test_col_trim.py)
SNAP_GRID = 32
# unanchored query head/tail can consume at most one column per base
# plus indel slack (bases); then extra slack in occupied-column units
# for columns contributed by family members other than the top ref.
# (The equality-vs-full-lattice tests in test_col_trim.py and the
# accuracy suite are the guard on these margins.)
_BASE_SLACK_FRAC = 0.08
_BASE_SLACK_MIN = 24
_EDGE_SLACK_COLS = 32


def _kmers_with_pos(
    masks: np.ndarray, k: int = _K
) -> tuple[np.ndarray, np.ndarray]:
    """(values, start positions) of all valid (unambiguous) k-mers."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = len(masks)
    if n < k:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    idx = alphabet.BASE_INDEX[masks & 0xF].astype(np.int64)
    ambig = alphabet.AMBIG_ORDER[masks & 0xF] != 1
    windows = sliding_window_view(idx, k)
    powers = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    vals = windows @ powers
    ok = ~sliding_window_view(ambig, k).any(axis=1)
    pos = np.nonzero(ok)[0].astype(np.int64)
    return vals[ok], pos


class RefAnchorTable:
    """Sorted k-mer table of one reference sequence (the family's
    top hit), reusable across the queries aligned against it."""

    __slots__ = ("vals", "pos", "n_bases")

    def __init__(self, masks: np.ndarray, k: int = _K):
        vals, pos = _kmers_with_pos(masks, k)
        order = np.argsort(vals, kind="stable")
        self.vals = vals[order]
        self.pos = pos[order]
        self.n_bases = len(masks)


def query_window(
    qmask: np.ndarray,
    table: RefAnchorTable,
    ref_positions: np.ndarray,
    cols: np.ndarray,
    k: int = _K,
) -> tuple[int, int, int] | None:
    """Alignment-column window that must contain the query's
    alignment against a family whose top reference is `table`
    (ref_positions: that reference's per-base alignment columns).

    `cols` is an ascending occupied-column array used for the edge
    slack and the window-size estimate — pass the WHOLE DB's occupied
    columns (computed once) and the result is family-independent:
    returns (lo_col, hi_col, est_len) with raw columns [lo, hi)
    widened by the slack, and est_len = the number of `cols` entries
    inside — an upper bound on any sub-family's occupied count there
    (a subset can only have fewer), so callers can shape-bucket on it
    and convert to exact family ranks later.

    Returns None when anchoring is unreliable (caller uses the full
    lattice)."""
    qv, qp = _kmers_with_pos(qmask, k)
    if len(qv) < _MIN_ANCHORS:
        return None
    left = np.searchsorted(table.vals, qv, side="left")
    right = np.searchsorted(table.vals, qv, side="right")
    matched = right > left
    if int(matched.sum()) < _MIN_ANCHORS:
        return None
    # expand ALL occurrences of each matched k-mer (capped): a
    # repeated segment would otherwise resolve every anchor to its
    # first copy, making a wrong-locus placement look diagonally
    # consistent.  With all occurrences in the offset pool, the
    # median lands on the true locus (which the majority of
    # non-repeat k-mers vote for) and per-k-mer we keep the
    # occurrence nearest that consensus.
    l_m = left[matched]
    r_m = np.minimum(right[matched], l_m + _MAX_OCC)
    counts = r_m - l_m
    occ_idx = np.repeat(l_m, counts) + (
        np.arange(int(counts.sum()))
        - np.repeat(np.cumsum(counts) - counts, counts)
    )
    rp = table.pos[occ_idx]
    qpm = np.repeat(qp[matched], counts)
    qlen = len(qmask)
    # diagonal consensus: anchors whose ref-base offset disagrees
    # with the median by more than the indel budget are repeats
    off = rp - qpm
    med = np.median(off)
    slack = max(int(_DIAG_SLACK_FRAC * qlen), _DIAG_SLACK_MIN)
    keep = np.abs(off - med) <= slack
    if int(keep.sum()) < _MIN_ANCHORS:
        return None
    rp = rp[keep]
    qpm = qpm[keep]
    base_slack = int(_BASE_SLACK_FRAC * qlen) + _BASE_SLACK_MIN
    i_lo = int(np.argmin(rp))
    i_hi = int(np.argmax(rp))
    lo_base = int(rp[i_lo]) - int(qpm[i_lo]) - base_slack
    hi_base = (
        int(rp[i_hi]) + (qlen - int(qpm[i_hi])) + base_slack + k
    )
    lo_base = max(lo_base, 0)
    hi_base = min(hi_base, table.n_bases - 1)
    lo_col = int(ref_positions[lo_base])
    hi_col = int(ref_positions[hi_base])
    # edge slack in occupied-column ranks, converted back to raw
    # columns
    rlo = int(np.searchsorted(cols, lo_col)) - _EDGE_SLACK_COLS
    rhi = (
        int(np.searchsorted(cols, hi_col, side="right"))
        + _EDGE_SLACK_COLS
    )
    rlo = max(rlo, 0)
    rhi = min(rhi, len(cols))
    if rhi <= rlo:
        return None
    lo_col = int(cols[rlo])
    hi_col = int(cols[rhi - 1]) + 1
    return lo_col, hi_col, rhi - rlo
