"""Column-profile reference ("pseq") — the default aligner engine.

Port of the semantics of pseq (/root/reference/src/pseq.{h,cpp}): the
family collapses to one profile entry per *occupied* alignment column
holding base frequencies and gap-open/extend fractions; alignment is a
plain affine chain DP against the profile (scoring_scheme_profile,
scoring_schemes.h:37-100).  The reference offers this as
``--fs-no-graph``; here it is the default engine because a chain DP
with column-local state batches cleanly: no gathers, the carry is one
V/D row, and the match cost is elementwise in the profile column and
the query base:

  sub[b, c, i] = (m - mm)·dot(p[c], q[i]) + mm·occ[c]
               + gp·gapO[c] + gpe·gapE[c]

On an NVIDIA GPU the DP runs as one CUDA kernel (ops/cuda/
chain_dp.cu); on the CPU, and for --insertion=forbid everywhere, as
the lax scan `chain_dp`, which is also the kernel's reference.
NAST post-processing is shared with graph mode.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from .. import alphabet
from ..sequence import Sequence
from .align_kernel import DpParams

# base order A G C U matching alphabet.BASE_*
_BASE_BITS = np.array(
    [alphabet.M_A, alphabet.M_G, alphabet.M_C, alphabet.M_TU],
    dtype=np.uint8,
)


@dataclass
class Profile:
    cols: np.ndarray     # (C,) int32 occupied alignment columns
    freqs: np.ndarray    # (C, 4) f32 base fractions (sum<=1)
    gap_open: np.ndarray  # (C,) f32 gap-open fraction
    gap_ext: np.ndarray   # (C,) f32 gap-extend fraction
    width: int

    @property
    def n_cols(self) -> int:
        return len(self.cols)


def build_profile(family: list[Sequence]) -> Profile:
    """Column sweep over the family (pseq.cpp:44-115): at each occupied
    column, distribute 12/ambig points over each present base's
    letters; absent sequences contribute gap-open (first occupied
    column after their base) or gap-extend points (12 each)."""
    width = family[0].width
    n = len(family)
    for s in family:
        if s.width != width:
            raise ValueError("family sequences differ in width")

    all_pos = np.concatenate([s.positions for s in family])
    all_mask = np.concatenate([s.masks for s in family]) & 0xF
    seq_ids = np.repeat(
        np.arange(n), [len(s.positions) for s in family]
    )
    amb = alphabet.AMBIG_ORDER[all_mask].astype(np.float64)
    w = 12.0 / np.maximum(amb, 1)

    pts = np.zeros((width, 4), dtype=np.float64)
    for b in range(4):
        has = (all_mask & _BASE_BITS[b]) != 0
        pts[:, b] = np.bincount(
            all_pos[has], weights=w[has], minlength=width
        )
    occupied = pts.sum(axis=1) > 0
    cols = np.nonzero(occupied)[0].astype(np.int32)
    C = len(cols)
    col_index = np.full(width, -1, dtype=np.int64)
    col_index[cols] = np.arange(C)

    # gap open/extend counts per occupied column (pseq.cpp:71-100):
    # a sequence absent from occupied column c contributes gap-open if
    # present at the previous occupied column, else gap-extend (the
    # reference's gap flag starts true, so leading columns extend)
    pres = np.zeros((n, C), dtype=bool)
    pres[seq_ids, col_index[all_pos]] = True
    prev = np.zeros((n, C), dtype=bool)
    prev[:, 1:] = pres[:, :-1]
    gapo = ((~pres) & prev).sum(axis=0).astype(np.float64)
    gape = ((~pres) & ~prev).sum(axis=0).astype(np.float64)

    total = pts[cols].sum(axis=1) + 12.0 * (gapo + gape)
    total = np.maximum(total, 1e-9)
    freqs = (pts[cols] / total[:, None]).astype(np.float32)
    return Profile(
        cols,
        freqs,
        (12.0 * gapo / total).astype(np.float32),
        (12.0 * gape / total).astype(np.float32),
        width,
    )


def _gather_family_arrays(seqs: list[Sequence]):
    """Fast path: when every sequence carries a `_flat_ref` stamp into
    the same shared flat arrays (ReferenceDb.ensure_flat), gather the
    concatenated (positions, masks&0xF, lengths) with one fancy index
    instead of concatenating thousands of small arrays."""
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0]
    if r0 is None:
        return None
    for r, s in zip(refs, seqs):
        if r is None or r[0] is not r0[0] or r[4] is not s.positions:
            return None
    flat_pos, flat_mask = r0[0], r0[1]
    n = len(seqs)
    starts = np.fromiter((r[2] for r in refs), np.int64, n)
    ends = np.fromiter((r[3] for r in refs), np.int64, n)
    lens = ends - starts
    total = int(lens.sum())
    idx = np.arange(total, dtype=np.int64)
    shift = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=shift[1:])
    idx += np.repeat(starts - shift, lens)
    return flat_pos[idx], flat_mask[idx], lens


def build_profiles_batch(
    families: list[list[Sequence]], cpad: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, list[np.ndarray]]:
    """Batched build_profile over many families at once (single
    bincount/segment passes across the whole bucket instead of
    per-family numpy calls).  Gap open/extend counts are computed
    event-wise (per base: is the next occupied column of this member
    adjacent?) so no members×columns presence matrix is ever built.

    Returns (freqs (B, cpad, 4) f32, gap_open (B, cpad) f32,
    gap_ext (B, cpad) f32, cols: per-family occupied column arrays).
    Semantics identical to build_profile (parity-tested)."""
    from .. import native

    B = len(families)
    width = families[0][0].width
    fam_sizes = np.array([len(f) for f in families], dtype=np.int64)
    seqs = [s for f in families for s in f]
    n_total = len(seqs)

    def _unpack_native(nat):
        freqs, gapo_out, gape_out, cols_flat, c_real = nat
        cols_list = [
            cols_flat[b, : int(c_real[b])] for b in range(B)
        ]
        return freqs, gapo_out, gape_out, cols_list

    # fastest path: C++ builder reading straight out of the shared
    # flat base store (_flat_ref stamps from ReferenceDb.ensure_flat)
    # — zero concatenation or gathering on the Python side
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    if r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    ):
        starts = np.fromiter((r[2] for r in refs), np.int64, n_total)
        ends = np.fromiter((r[3] for r in refs), np.int64, n_total)
        nat = native.build_profiles(
            r0[0], r0[1], starts, ends - starts, fam_sizes,
            width, cpad,
        )
        if nat is not None:
            return _unpack_native(nat)

    fast = _gather_family_arrays(seqs) if seqs else None
    if fast is not None:
        all_pos, all_mask, base_counts = fast
    else:
        base_counts = np.array(
            [len(s.positions) for s in seqs], dtype=np.int64
        )
        all_pos = (
            np.concatenate([s.positions for s in seqs])
            if seqs
            else np.zeros(0, np.int64)
        ).astype(np.int64)
        all_mask = (
            np.concatenate([s.masks for s in seqs])
            if seqs
            else np.zeros(0, np.uint8)
        ) & 0xF
    starts = np.zeros(n_total, dtype=np.int64)
    np.cumsum(base_counts[:-1], out=starts[1:])
    nat = native.build_profiles(
        all_pos, all_mask, starts, base_counts, fam_sizes,
        width, cpad,
    )
    if nat is not None:
        return _unpack_native(nat)

    fam_of_seq = np.repeat(np.arange(B), fam_sizes)
    seq_of_base = np.repeat(np.arange(n_total), base_counts)
    fam_of_base = fam_of_seq[seq_of_base]
    gpos = fam_of_base * width + all_pos  # globalised columns

    amb = alphabet.AMBIG_ORDER[all_mask].astype(np.float64)
    w = 12.0 / np.maximum(amb, 1)
    pts = np.zeros((B * width, 4), dtype=np.float64)
    for b4 in range(4):
        has = (all_mask & _BASE_BITS[b4]) != 0
        pts[:, b4] = np.bincount(
            gpos[has], weights=w[has], minlength=B * width
        )
    pts = pts.reshape(B, width, 4)
    occupied = pts.sum(axis=2) > 0              # (B, width)

    cols_list = []
    col_index = np.full((B, width), -1, dtype=np.int64)
    c_real = np.zeros(B, dtype=np.int64)
    for b in range(B):
        cols = np.nonzero(occupied[b])[0]
        cols_list.append(cols.astype(np.int32))
        col_index[b, cols] = np.arange(len(cols))
        c_real[b] = len(cols)

    # per-member presence/transition counts, bincount-style
    # (pseq.cpp:71-100 semantics: absent at col c = gap-open if the
    # member is present at col c-1, else gap-extend)
    ci = col_index[fam_of_base, all_pos]        # occupied-col index
    nb = len(ci)
    present = np.bincount(
        fam_of_base * cpad + ci, minlength=B * cpad
    ).reshape(B, cpad)
    # a gap OPENS at ci+1 whenever this member's next base is not at
    # the adjacent occupied column (or this is its last base)
    nxt = np.empty(nb, dtype=np.int64)
    if nb:
        nxt[:-1] = ci[1:]
        nxt[-1] = -2
    same = np.zeros(nb, dtype=bool)
    if nb > 1:
        same[:-1] = seq_of_base[1:] == seq_of_base[:-1]
    event = (ci + 1 < c_real[fam_of_base]) & (
        ~same | (nxt != ci + 1)
    )
    gapo = (
        np.bincount(
            fam_of_base[event] * cpad + ci[event] + 1,
            minlength=B * cpad,
        )
        .reshape(B, cpad)
        .astype(np.float64)
    )
    colid = np.arange(cpad)[None, :]
    valid = colid < c_real[:, None]
    absent = np.where(valid, fam_sizes[:, None] - present, 0)
    gape = absent - gapo

    freqs = np.zeros((B, cpad, 4), dtype=np.float32)
    gapo_out = np.zeros((B, cpad), dtype=np.float32)
    gape_out = np.zeros((B, cpad), dtype=np.float32)
    for b in range(B):
        C = int(c_real[b])
        p = pts[b, cols_list[b]]                  # (C, 4)
        total = p.sum(axis=1) + 12.0 * (
            gapo[b, :C] + gape[b, :C]
        )
        total = np.maximum(total, 1e-9)
        freqs[b, :C] = (p / total[:, None]).astype(np.float32)
        gapo_out[b, :C] = (12.0 * gapo[b, :C] / total).astype(
            np.float32
        )
        gape_out[b, :C] = (12.0 * gape[b, :C] / total).astype(
            np.float32
        )
    return freqs, gapo_out, gape_out, cols_list


def can_window_batch(families: list[list[Sequence]]) -> bool:
    """True when window-restricted building is available for these
    families: native lib present + every member stamped into one
    shared flat store (the same precondition the builder checks)."""
    from .. import native

    if native.get_lib() is None:
        return False
    seqs = [s for f in families for s in f]
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    return r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    )


def build_profiles_packed_batch(
    families: list[list[Sequence]], cpad: int, params: "DpParams",
    windows: list[tuple[int, int] | None] | None = None,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """build_profiles_batch emitting the device wire format directly:
    fgq (B, cpad, 6) uint8 (see _pack_fgq) + per-family occupied
    column arrays.  The native builder quantises in-loop (bit-exact
    vs _pack_fgq, parity-tested), skipping the (B, cpad, 4) f32
    freqs / gapcost intermediates entirely; without the native
    library this falls back to build + pack.

    `windows` (requires can_window_batch): per-family raw-column
    window [lo, hi) or None for full — members restrict to their
    in-window base subranges (sina_member_ranges), so the profile
    and its cols array cover the window only.  An amplicon batch's
    profiles otherwise build ~70% out-of-window bases.

    Known one-column edge deviation vs the full build: at the
    window's FIRST occupied column, members whose last pre-window
    base sits at the family's occupied column immediately below
    `lo` would count as gap-OPEN there in a full build; the clipped
    ranges lose that context, so they count as gap-extend instead
    (the full build's rank-0 column has the same all-extend
    property).  Affects the deletion cost of exactly one lattice
    column (the union window's first), i.e. deleting it can be
    cheaper by at most gap_open - gap_ext; recorded in PARITY.md."""
    from .. import native

    B = len(families)
    width = families[0][0].width
    fam_sizes = np.array([len(f) for f in families], dtype=np.int64)
    seqs = [s for f in families for s in f]
    n_total = len(seqs)

    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    if r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    ):
        starts = np.fromiter((r[2] for r in refs), np.int64, n_total)
        ends = np.fromiter((r[3] for r in refs), np.int64, n_total)
        counts = ends - starts
        if windows is not None:
            lo = np.array(
                [-1 if w is None else w[0] for w in windows],
                np.int64,
            )
            hi = np.array(
                [-1 if w is None else w[1] for w in windows],
                np.int64,
            )
            sliced = native.member_ranges(
                r0[0], starts, counts, fam_sizes, lo, hi
            )
            if sliced is None:
                raise RuntimeError(
                    "windowed profile build requested without "
                    "native support (check can_window_batch first)"
                )
            starts, counts = sliced
        nat = native.build_profiles_packed(
            r0[0], r0[1], starts, counts, fam_sizes,
            width, cpad,
            params.gap_open, params.gap_ext, _gap_scale(params),
        )
        if nat is not None:
            fgq, cols_flat, c_real = nat
            return fgq, [
                cols_flat[b, : int(c_real[b])] for b in range(B)
            ]
    if windows is not None:
        raise RuntimeError(
            "windowed profile build requested without native "
            "support (check can_window_batch first)"
        )

    freqs, gapo, gape, cols_list = build_profiles_batch(
        families, cpad
    )
    gapcost = (
        params.gap_open * gapo + params.gap_ext * gape
    ).astype(np.float32)
    return _pack_fgq(freqs, gapcost, params), cols_list


def query_profile_weights(qmask: np.ndarray) -> np.ndarray:
    """(M, 4) f32: each query base spread over its IUPAC letters
    (base_profile(base_iupac), pseq.h:66-86)."""
    m = qmask & 0xF
    amb = alphabet.AMBIG_ORDER[m].astype(np.float32)
    w = 1.0 / np.maximum(amb, 1)
    out = np.zeros((len(qmask), 4), dtype=np.float32)
    for b in range(4):
        has = (m & _BASE_BITS[b]) != 0
        out[has, b] = w[has]
    return out


from .align_kernel import _windowed_min


def chain_dp(sub, del_open, del_ext, go, ge, qlen, c_real,
             c_cols: int, m_len: int,
             ins_budget=None):
    """Affine chain DP against a profile (scoring_scheme_profile
    semantics): like align_kernel.poa_dp_costs but specialised for
    predecessor == previous column, so the scan carry is just the
    previous V/D rows — no lattice gathers.

    del_open/del_ext are per-column (C,) deletion costs — scaled by
    column occupancy so skipping a column only a few family members
    populate is as cheap as the graph's bypass edges make it.
    Insertion costs go/ge stay flat (scoring_schemes.h:47-64).

    Returns (bp (C, M) uint16 in the shared packing with slots 0,
    best_c, best_i, raw).
    """
    import jax
    import jax.numpy as jnp
    from .align_kernel import BIG, CODE_DEL, CODE_MATCH, CODE_INS

    C, M = c_cols, m_len
    iidx = jnp.arange(M, dtype=jnp.float32)
    col0_edge = jnp.arange(M) == 0

    aspace = ins_budget is not None

    def step(carry, xs):
        Vp, Dp, vend_row = carry
        if aspace:
            subrow, dgo, dge, budget, j = xs
        else:
            subrow, dgo, dge, j = xs
        base = jnp.where((j == 0) | col0_edge, jnp.float32(1.0), BIG)

        d_open = Vp + dgo
        d_ext = Dp + dge
        dmin = jnp.minimum(d_open, d_ext)
        dsel_open = d_open < d_ext
        Drow = jnp.minimum(base, dmin)

        Vp_prev = jnp.concatenate([jnp.array([BIG]), Vp[:-1]])
        Mc = Vp_prev + subrow

        U = base
        codeU = jnp.zeros(M, dtype=jnp.uint16)
        take_d = dmin < U
        U = jnp.where(take_d, dmin, U)
        codeU = jnp.where(take_d, jnp.uint16(CODE_DEL), codeU)
        take_m = Mc < U
        U = jnp.where(take_m, Mc, U)
        codeU = jnp.where(take_m, jnp.uint16(CODE_MATCH), codeU)

        cand = U + go - (iidx + 1.0) * ge
        if aspace:
            # bounded insertion runs (--insertion=forbid): no edge
            # seed, run length <= budget (mesh.h:403-437)
            wm = _windowed_min(cand, budget, M)
            prefix = jnp.concatenate([jnp.array([BIG]), wm[:-1]])
            prefix = jnp.where(budget < 1, BIG, prefix)
            Irow = prefix + iidx * ge
        else:
            run = jax.lax.cummin(cand)
            seed = jnp.float32(1.0)
            prefix = jnp.concatenate(
                [jnp.array([seed]), jnp.minimum(run[:-1], seed)]
            )
            Irow = prefix + iidx * ge
        Iprev = jnp.concatenate([jnp.array([BIG]), Irow[:-1]])
        Uprev = jnp.concatenate([jnp.array([BIG]), U[:-1]])
        ins_opened = ((Uprev + go) <= (Iprev + ge)) | (
            Irow + 1e-4 < Iprev + ge
        )

        take_i = Irow <= U
        Vrow = jnp.where(take_i, Irow, U)
        code = jnp.where(take_i, jnp.uint16(CODE_INS), codeU)

        bp_row = (
            code
            | (dsel_open.astype(jnp.uint16) << 8)
            | (ins_opened.astype(jnp.uint16) << 9)
        )
        vlast = Vrow[qlen - 1]
        vend_row = jnp.where(j == c_real - 1, Vrow, vend_row)
        return (Vrow, Drow, vend_row), (bp_row, vlast)

    import jax

    Vp0 = jnp.full((M,), BIG, dtype=jnp.float32)
    xs = (
        (sub, del_open, del_ext, ins_budget, jnp.arange(C))
        if aspace
        else (sub, del_open, del_ext, jnp.arange(C))
    )
    (Vp, Dp, vend_row), (bp, vlast) = jax.lax.scan(
        step, (Vp0, Vp0, Vp0), xs
    )
    col_valid = jnp.arange(C) < c_real
    c1 = jnp.where(col_valid, vlast, BIG)
    j1 = jnp.argmin(c1)
    v1 = c1[j1]
    iok = jnp.arange(M) < qlen
    c2 = jnp.where(iok, vend_row, BIG)
    i2 = jnp.argmin(c2)
    v2 = c2[i2]
    use2 = v2 < v1
    best_c = jnp.where(use2, c_real - 1, j1)
    best_i = jnp.where(use2, i2, qlen - 1)
    raw = jnp.where(use2, v2, v1)
    return bp, best_c, best_i, raw


def sub_costs(freqs, gapcost, qmask, c_real, params: DpParams):
    """Substitution costs of one query against its profile, and the
    per-column occupancy that scales the deletion costs:

      sub[c, i] = (m - mm)·dot(p[c], q[i]) + mm·occ[c]·|q[i]| + gap[c]

    freqs (C, 4), gapcost (C,), qmask (M,) uint8 IUPAC masks.  The
    CUDA kernel (ops/cuda/chain_dp.cu) evaluates the same terms in the
    same f32 order.  Returns (sub (C, M) with BIG past c_real,
    occ (C,))."""
    import jax.numpy as jnp
    from .align_kernel import BIG

    m = jnp.float32(params.match)
    mm = jnp.float32(params.mismatch)
    C = freqs.shape[0]
    qm = (qmask & 0xF).astype(jnp.int32)
    b0 = (qm & 1).astype(jnp.float32)
    b1 = ((qm >> 1) & 1).astype(jnp.float32)
    b2 = ((qm >> 2) & 1).astype(jnp.float32)
    b3 = ((qm >> 3) & 1).astype(jnp.float32)
    cnt = b0 + b1 + b2 + b3
    inv = jnp.where(cnt > 0, 1.0 / jnp.maximum(cnt, 1.0), 0.0)
    dot = (
        freqs[:, 0][:, None] * (b0 * inv)[None, :]
        + freqs[:, 1][:, None] * (b1 * inv)[None, :]
        + freqs[:, 2][:, None] * (b2 * inv)[None, :]
        + freqs[:, 3][:, None] * (b3 * inv)[None, :]
    )
    occ = freqs[:, 0] + freqs[:, 1] + freqs[:, 2] + freqs[:, 3]
    qs = (cnt * inv)[None, :]
    sub = (m - mm) * dot + mm * occ[:, None] * qs + gapcost[:, None]
    sub = jnp.where(jnp.arange(C)[:, None] >= c_real, BIG, sub)
    return sub, occ


def _gap_scale(params: DpParams) -> float:
    """Static fixed-point scale for the int16 gap-cost transfer:
    gapcost = go*open_frac + ge*ext_frac <= go + ge, so this maps the
    full range into +/-32000 exactly the same way on host and
    device."""
    return 32000.0 / max(params.gap_open + params.gap_ext, 1.0)


def _pack_fgq(freqs, gapcost, params: DpParams) -> np.ndarray:
    """Quantised profile transfer: (B, C, 6) uint8 = 4 bytes of
    freqs (x255 fixed point) + 2 bytes of gap cost (int16 fixed
    point).  40% fewer host->device bytes than f16 at negligible
    cost noise (<0.5% of a match score)."""
    B, C = gapcost.shape
    fgq = np.empty((B, C, 6), dtype=np.uint8)
    np.rint(
        np.asarray(freqs) * 255.0, out=fgq[:, :, :4],
        casting="unsafe",
    )
    gi = np.rint(
        np.asarray(gapcost) * _gap_scale(params)
    ).astype(np.int16)
    fgq[:, :, 4:6] = gi.view(np.uint8).reshape(B, C, 2)
    return fgq


def _device_unpack_fgq(fgq, params: DpParams):
    """Invert _pack_fgq on device: (freqs (B,C,4) f32, gapcost (B,C)
    f32)."""
    import jax
    import jax.numpy as jnp

    fq = fgq[:, :, :4].astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    gc = jax.lax.bitcast_convert_type(
        fgq[:, :, 4:6], jnp.int16
    ).astype(jnp.float32) * jnp.float32(1.0 / _gap_scale(params))
    return fq, gc


@functools.lru_cache(maxsize=64)
def _profile_batched_fn(
    C: int, M: int, params: DpParams, aspace: bool = False,
    dedup: bool = False,
):
    import jax
    import jax.numpy as jnp
    from .align_kernel import traceback_device

    go = jnp.float32(params.gap_open)
    ge = jnp.float32(params.gap_ext)
    chain_preds = (
        jnp.arange(C, dtype=jnp.int32) - 1
    ).reshape(C, 1)
    is_start = jnp.arange(C) == 0

    def core(freqs, gapcost, qmask, qlen, c_real, budget=None):
        sub, occ = sub_costs(freqs, gapcost, qmask, c_real, params)
        bp, bc, bi, raw = chain_dp(
            sub, go * occ, ge * occ, go, ge, qlen, c_real, C, M,
            ins_budget=budget,
        )
        emit = traceback_device(
            bp, bc, bi, chain_preds, is_start, C, M
        )
        return emit, bc, bi, raw

    if aspace:
        vm = jax.vmap(core, in_axes=(0, 0, 0, 0, 0, 0))

        def packed(fgq, qmask, lens, budget, fam_idx=None):
            fq, gc = _device_unpack_fgq(fgq, params)
            if dedup:
                # unique-profile transfer (amplicon workloads share
                # families): fgq holds U<B unique profiles, fam_idx
                # maps each query to its row
                fq = jnp.take(fq, fam_idx, axis=0)
                gc = jnp.take(gc, fam_idx, axis=0)
            out = vm(
                fq, gc, qmask,
                lens[:, 0], lens[:, 1], budget,
            )
            return _pack_result(*out)

        return jax.jit(packed)
    vm = jax.vmap(core, in_axes=(0, 0, 0, 0, 0))

    def packed(fgq, qmask, lens, fam_idx=None):
        fq, gc = _device_unpack_fgq(fgq, params)
        if dedup:
            fq = jnp.take(fq, fam_idx, axis=0)
            gc = jnp.take(gc, fam_idx, axis=0)
        out = vm(
            fq, gc, qmask,
            lens[:, 0], lens[:, 1],
        )
        return _pack_result(*out)

    return jax.jit(packed)


def _pack_result(emit, bc, bi, raw):
    """Single-array result so one fetch crosses the host link:
    (B, M+3) int32 = [emit | bc | bi | bitcast(raw)]."""
    import jax
    import jax.numpy as jnp

    aux = jnp.stack(
        [
            bc.astype(jnp.int32),
            bi.astype(jnp.int32),
            jax.lax.bitcast_convert_type(
                raw.astype(jnp.float32), jnp.int32
            ),
        ],
        axis=1,
    )
    return jnp.concatenate([emit, aux], axis=1)


def _unpack_result(packed: np.ndarray):
    emit = packed[:, :-3]
    bc = packed[:, -3]
    bi = packed[:, -2]
    raw = packed[:, -1].view(np.float32)
    return emit, bc, bi, raw


# chain traceback over the compact backpointer layout -----------------

_S_RESOLVE = 0
_S_CHAIN = 1
_S_DECIDE = 2
_S_INS = 3
_S_CHAIN_NE = 5
_S_DONE = 6


def chain_traceback_log(bp, best_c, best_i, c_cols: int, m_len: int):
    """Chain traceback over the compact uint8 backpointers the CUDA
    kernel writes (bits 0-1 V choice, bit 2 deletion opened, bit 3
    insertion opened).  A fori_loop over a static step count whose
    induction variable indexes the emission log, so under vmap every
    lane writes the same log slot per step (a uniform
    dynamic_update_slice instead of a batched scatter).  Returns
    log (L,) int32 of the emitting column j (-1 = idle step).

    The emitted query index is not logged: emissions consume query
    bases in strictly consecutive decreasing order from best_i (every
    base in [head, best_i] is consumed exactly once — matches emit on
    _S_RESOLVE, insertions per base in _S_INS), so the host
    reconstructs query_i = best_i - (emission ordinal)."""
    import jax
    import jax.numpy as jnp
    from .align_kernel import CODE_DEL, CODE_EDGE, CODE_INS, CODE_MATCH

    L = c_cols + 2 * m_len + 8

    def step(j, i, state):
        cell = bp[j, i].astype(jnp.int32)
        code = cell & 0x3
        dopen = (cell >> 2) & 1
        iopen = (cell >> 3) & 1
        at_edge = (i == 0) | (j == 0)

        def s_resolve(_):
            is_del = (code == CODE_DEL) & ~at_edge
            ns = jnp.where(is_del, _S_CHAIN, _S_DECIDE)
            return j, i, ns, jnp.where(is_del, -1, i), j

        def mk_chain(nxt):
            def s_chain(_):
                pj = jnp.maximum(j - 1, 0)
                stop = (dopen == 1) | (pj == 0)
                chain = (
                    _S_CHAIN if nxt == _S_RESOLVE else _S_CHAIN_NE
                )
                return pj, i, jnp.where(stop, nxt, chain), -1, j
            return s_chain

        def s_decide(_):
            done = at_edge | (code == CODE_EDGE)
            is_m = code == CODE_MATCH
            is_i = code == CODE_INS
            nj = jnp.where(is_m & ~done, j - 1, j)
            ni = jnp.where(is_m & ~done, i - 1, i)
            ns = jnp.where(
                done, _S_DONE,
                jnp.where(
                    is_m, _S_RESOLVE,
                    jnp.where(is_i, _S_INS, _S_CHAIN_NE),
                ),
            )
            return nj, ni, ns, -1, j

        def s_ins(_):
            ni = i - 1
            done = ni < 0
            safe = jnp.maximum(ni, 0)
            ns = jnp.where(
                done, _S_DONE,
                jnp.where(iopen == 1, _S_DECIDE, _S_INS),
            )
            return j, safe, ns, jnp.where(done, -1, safe), j

        def s_done(_):
            return j, i, jnp.int32(_S_DONE), -1, j

        nj, ni, ns, ei, ej = jax.lax.switch(
            jnp.minimum(state, 6),
            [
                s_resolve,
                mk_chain(_S_RESOLVE),
                s_decide,
                s_ins,
                s_resolve,
                mk_chain(_S_DECIDE),
                s_done,
            ],
            None,
        )
        return nj, ni, ns, jnp.where(ei >= 0, ej, -1)

    # UNROLL state transitions per fori iteration: each is a handful
    # of scalar ops whose cost is dominated by loop bookkeeping
    UNROLL = 4
    Lp = -(-L // UNROLL) * UNROLL

    def body(it, carry):
        j, i, state, log = carry
        rows = []
        for _ in range(UNROLL):
            j, i, state, row = step(j, i, state)
            rows.append(row)
        log = jax.lax.dynamic_update_slice(
            log, jnp.stack(rows), (it * UNROLL,)
        )
        return j, i, state, log

    log0 = jnp.full((Lp,), -1, dtype=jnp.int32)
    _, _, _, log = jax.lax.fori_loop(
        0,
        Lp // UNROLL,
        body,
        (
            best_c.astype(jnp.int32),
            best_i.astype(jnp.int32),
            jnp.int32(_S_RESOLVE),
            log0,
        ),
    )
    return log[:L]


@functools.lru_cache(maxsize=64)
def _profile_kernel_fn(
    C: int, M: int, params: DpParams, dedup: bool = False,
    chain=None,
):
    """GPU path: the CUDA chain DP (substitution costs and end
    selection in-kernel, so neither the (B, C, M) cost tensor nor the
    V plane exists in device memory) + the lax traceback over its
    compact backpointers.  The traceback log and the (best_c, best_i,
    raw) words ship as one int16 array when C, M < 32000, else int32.
    `chain` is the kernel call (chain_dp_cuda.chain_dp_cuda); tests on
    the CPU pass chain_dp_cuda.chain_dp_reference, which has the same
    contract."""
    import jax
    import jax.numpy as jnp

    from . import chain_dp_cuda

    chain = chain or chain_dp_cuda.chain_dp_cuda
    per_thread, m_pad = chain_dp_cuda.layout(M)
    compact = max(C, M) < 32000

    def packed(fgq, qmask, lens, fam_idx=None):
        fq, gc = _device_unpack_fgq(fgq, params)
        if dedup:
            fq = jnp.take(fq, fam_idx, axis=0)
            gc = jnp.take(gc, fam_idx, axis=0)
        qm = jnp.pad(qmask, ((0, 0), (0, m_pad - M)))
        bp, bc, bi, raw = chain(fq, gc, qm, lens, params, per_thread)
        log = jax.vmap(
            lambda b, c, i: chain_traceback_log(b, c, i, C, M)
        )(bp, bc, bi)                      # (B, L) column-only log
        B = log.shape[0]
        aux = jnp.stack(
            [
                bc.astype(jnp.int32),
                bi.astype(jnp.int32),
                jax.lax.bitcast_convert_type(
                    raw.astype(jnp.float32), jnp.int32
                ),
            ],
            axis=1,
        )
        if compact:
            log16 = log.astype(jnp.int16)
            aux16 = jax.lax.bitcast_convert_type(
                aux, jnp.int16
            ).reshape(B, -1)
            return jnp.concatenate([log16, aux16], axis=1)
        return jnp.concatenate([log, aux], axis=1)

    return jax.jit(packed)


def _wire_layout(B: int, U: int, C: int, M: int, dedup: bool,
                 aspace: bool):
    """Byte offsets of the single coalesced h2d buffer.  int32
    segments first (offset 0 is aligned and every int32 segment size
    is a multiple of 4), byte segments last:
    [lens (B,2) i32 | fam_idx (B,) i32? | budget (B,C) i32? |
     fgq (U,C,6) u8 | qmask (B,M) u8]."""
    n_lens = B * 2 * 4
    n_fi = B * 4 if dedup else 0
    n_bud = B * C * 4 if aspace else 0
    n_fg = U * C * 6
    n_qm = B * M
    return n_lens, n_fi, n_bud, n_fg, n_qm


@functools.lru_cache(maxsize=256)
def _profile_wire_fn(
    C: int, M: int, params: DpParams, B: int, U: int,
    aspace: bool, dedup: bool, kernel: bool,
):
    """One-transfer DP entry: takes the single flat uint8 wire buffer
    (see _wire_layout) and splits it device-side with static slices +
    bitcasts, then runs the CUDA chain kernel path (kernel=True,
    _profile_kernel_fn) or the XLA path.  One host->device copy per
    launch instead of 3-5."""
    import jax
    import jax.numpy as jnp

    inner = (
        _profile_kernel_fn(C, M, params, dedup=dedup)
        if kernel
        else _profile_batched_fn(C, M, params, aspace=aspace,
                                 dedup=dedup)
    )
    n_lens, n_fi, n_bud, n_fg, n_qm = _wire_layout(
        B, U, C, M, dedup, aspace
    )

    def f(wire):
        o = 0
        lens = jax.lax.bitcast_convert_type(
            wire[o : o + n_lens].reshape(B, 2, 4), jnp.int32
        )
        o += n_lens
        fi = None
        if dedup:
            fi = jax.lax.bitcast_convert_type(
                wire[o : o + n_fi].reshape(B, 4), jnp.int32
            )
            o += n_fi
        bud = None
        if aspace:
            bud = jax.lax.bitcast_convert_type(
                wire[o : o + n_bud].reshape(B, C, 4), jnp.int32
            )
            o += n_bud
        fg = wire[o : o + n_fg].reshape(U, C, 6)
        o += n_fg
        qm = wire[o : o + n_qm].reshape(B, M)
        if aspace:
            return inner(fg, qm, lens, bud, fi)
        return inner(fg, qm, lens, fi)

    return jax.jit(f)


def _build_wire(fg, qmask, lens, fam_idx, budget, C: int, M: int,
                dedup: bool, aspace: bool) -> np.ndarray:
    """Assemble the flat uint8 h2d buffer (see _wire_layout)."""
    B = qmask.shape[0]
    U = fg.shape[0]
    n_lens, n_fi, n_bud, n_fg, n_qm = _wire_layout(
        B, U, C, M, dedup, aspace
    )
    wire = np.empty(n_lens + n_fi + n_bud + n_fg + n_qm,
                    dtype=np.uint8)
    o = 0
    wire[o : o + n_lens].view(np.int32).reshape(B, 2)[...] = lens
    o += n_lens
    if dedup:
        wire[o : o + n_fi].view(np.int32)[...] = np.asarray(
            fam_idx, dtype=np.int32
        )
        o += n_fi
    if aspace:
        wire[o : o + n_bud].view(np.int32).reshape(B, C)[...] = budget
        o += n_bud
    np.copyto(wire[o : o + n_fg].reshape(U, C, 6), fg)
    o += n_fg
    np.copyto(wire[o : o + n_qm].reshape(B, M),
              np.asarray(qmask, dtype=np.uint8))
    return wire


def _unpack_log_result(packed: np.ndarray, m_len: int):
    """Convert the packed column-only log to (emit, bc, bi, raw).
    Accepts the int32 layout (B, L+3) or the compact int16 layout
    (B, L+6) where the three aux words are bitcast int32 halves.
    The k-th logged emission (in step order) consumed slave base
    best_i - k (see chain_traceback_log)."""
    B = packed.shape[0]
    if packed.dtype == np.int16:
        aux = np.ascontiguousarray(packed[:, -6:]).view(np.int32)
        log = packed[:, :-6].astype(np.int32)
    else:
        aux = packed[:, -3:]
        log = packed[:, :-3]
    bi = aux[:, 1]
    emit = np.full((B, m_len), -1, dtype=np.int32)
    mask = log >= 0
    ordinal = np.cumsum(mask, axis=1) - 1
    bidx, step = np.nonzero(mask)
    ei = bi[bidx] - ordinal[bidx, step]
    emit[bidx, ei] = log[bidx, step]
    return (
        emit,
        aux[:, 0],
        bi,
        aux[:, 2].copy().view(np.float32),
    )


def _bucket_rows(n: int) -> int:
    """Batch-axis compile bucket: the row count of every device
    array is a traced shape dimension, so an unpadded per-bucket
    batch size mints a fresh compile per distinct value, and a
    compile inside the run costs far more than the DP call itself.
    Powers of two (min 16): a handful of shapes ever compile, and
    padded rows cost far less than shape churn."""
    b = 16
    while b < n:
        b *= 2
    return b


# (C, M, params, aspace, dedup) tuples that have dispatched at least
# once — prewarm_row_buckets compiles their remaining row buckets
_seen_shapes: set[tuple] = set()


def prewarm_row_buckets(max_rows: int = 128) -> None:
    """Compile every row bucket <= max_rows for each (C, M) shape
    seen so far, so data-dependent bucket splits never hit a fresh
    compile mid-run.  Call once after the warmup batch (bench.py /
    pipeline warmup); persistent-cache hits make repeat runs cheap."""
    for (C, M, params, aspace, dedup) in list(_seen_shapes):
        if dedup:
            # two independent shape axes (unique rows, batch rows) —
            # combinatorial to prewarm; dedup workloads stabilise on
            # a couple of shapes within the first batches instead
            continue
        buckets, b = [], 16
        while b < _bucket_rows(max_rows):
            buckets.append(b)
            b *= 2
        buckets.append(b)
        for Bb in buckets:
            fg = np.zeros((Bb, C, 6), dtype=np.uint8)
            qm = np.zeros((Bb, M), dtype=np.uint8)
            ql = np.ones(Bb, dtype=np.int32)
            cr = np.ones(Bb, dtype=np.int32)
            bud = (
                np.zeros((Bb, C), dtype=np.int32) if aspace else None
            )
            profile_dp_fetch(
                profile_dp_dispatch(
                    None, None, qm, ql, cr, params,
                    budget=bud, _prepacked=fg,
                )
            )


def profile_dp_dispatch(
    freqs, gapcost, qmask, qlen, c_real, params: DpParams,
    budget=None, fam_idx=None, _prepacked=None,
):
    """Dispatch the batched profile DP WITHOUT fetching: freqs
    (B, C, 4), gapcost (B, C), qmask (B, M) uint8 IUPAC masks, qlen
    (B,), c_real (B,) as NUMPY arrays.  The profile ships quantised
    (_pack_fgq: 6 bytes/column) and the query as raw masks (the
    device rebuilds the f32 query profile elementwise), and the
    device→host result starts copying back
    asynchronously — callers overlap the in-flight work with host
    post-processing and fetch via profile_dp_fetch.  `budget` (B, C)
    enables the aspace-aware bounded-insertion mode
    (--insertion=forbid; XLA path only).  With `fam_idx` (B,) int32,
    freqs/gapcost hold only the batch's UNIQUE profiles (U rows,
    U <= B) and each query b aligns against row fam_idx[b] — the
    device gathers, so duplicated families (common for amplicon
    workloads) cross the host link once.

    The batch axis is padded to _bucket_rows(B) before anything is
    traced (see there); profile_dp_fetch slices the padding back
    off."""
    import jax.numpy as jnp

    from ..backend import dp_backend
    from ..timing import get_timer

    t = get_timer("ProfileDP")
    dedup = fam_idx is not None
    with t.section("pack fgq"):
        if _prepacked is not None:
            fg = _prepacked
        else:
            fg = _pack_fgq(freqs, gapcost, params)
        C, M = fg.shape[1], qmask.shape[1]
        lens = np.stack(
            [np.asarray(qlen), np.asarray(c_real)], axis=1
        ).astype(np.int32)
        B = qmask.shape[0]
        B_pad = _bucket_rows(B)
        if B_pad != B:
            pad = B_pad - B
            if dedup:
                # padded lanes gather unique row 0 (always present)
                fam_idx = np.concatenate(
                    [np.asarray(fam_idx, np.int32),
                     np.zeros(pad, np.int32)]
                )
            else:
                fg = np.concatenate(
                    [fg, np.zeros((pad,) + fg.shape[1:], fg.dtype)]
                )
            qmask = np.concatenate(
                [qmask,
                 np.zeros((pad, M), dtype=np.asarray(qmask).dtype)]
            )
            lens = np.concatenate(
                [lens, np.ones((pad, 2), dtype=np.int32)]
            )
            if budget is not None:
                budget = np.concatenate(
                    [budget,
                     np.zeros((pad, C), dtype=np.asarray(budget).dtype)]
                )
    _seen_shapes.add((C, M, params, budget is not None, dedup))
    aspace = budget is not None
    U = fg.shape[0]
    with t.section("h2d"):
        wire = _build_wire(fg, qmask, lens, fam_idx, budget,
                           C, M, dedup, aspace)
        wire_d = jnp.asarray(wire)
    kernel = not aspace and dp_backend() == "cuda"
    with t.section("launch"):
        fn = _profile_wire_fn(
            C, M, params, B_pad, U, aspace=aspace, dedup=dedup,
            kernel=kernel,
        )
        out = fn(wire_d)
        out.copy_to_host_async()
    kind = "log" if kernel else "xla"
    return (kind, out, M, B)


def profile_dp_fetch(handle):
    """Fetch a profile_dp_dispatch result: numpy (emit (B, M),
    best_c, best_i, raw)."""
    kind, out, M, B = handle
    if kind == "log":
        return _unpack_log_result(np.asarray(out)[:B], M)
    return _unpack_result(np.asarray(out)[:B])


def profile_dp_batch(
    freqs, gapcost, qmask, qlen, c_real, params: DpParams,
    budget=None,
):
    """Synchronous dispatch+fetch convenience wrapper."""
    return profile_dp_fetch(
        profile_dp_dispatch(
            freqs, gapcost, qmask, qlen, c_real, params,
            budget=budget,
        )
    )
