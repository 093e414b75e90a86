"""Batched POA-graph alignment DP.

Implements the min-cost affine-gap lattice of the reference's mesh
engine (/root/reference/src/mesh.h:263-528) as a scan over
topologically-sorted graph nodes, computing one whole query-length row
of cells per step with vector ops — batched over queries via vmap.

Recurrences per node row j (min-cost; edge cells start at 1, matching
``init_edge``, mesh.h:294-302):

  D[j,i] = min(baseD, min_p min(V[p,i] + go*wd_j, D[p,i] + ge*wd_j))
  Mc[j,i] = min_p V[p,i-1] + sub(j,i)
  U[j,i] = prio-min(base, D, Mc)
  I[j,i] = min(U[j,i-1] + go*wi_j, I[j,i-1] + ge*wi_j), I[j,0]=base
  V[j,i] = I if I <= U else U        (insertion wins ties, mesh.h:351)

The insertion track is solved in closed form per row with a prefix-min
(cummin), keeping the whole row data-parallel.

Documented deviations from the reference (see DESIGN.md):
  * insertion track is true Gotoh; the reference greedily re-opens
    (mesh.h:340-349).
  * deletion track takes min over predecessors; the reference keeps the
    last predecessor's gap run (mesh.h:305-330).
  * ties among predecessors resolve to the lowest node id.

Backpointers are packed per cell into uint16:
  bits 0-1  V choice: 0=edge, 1=match, 2=deletion, 3=insertion
  bits 2-4  match predecessor slot
  bits 5-7  deletion predecessor slot
  bit  8    deletion opened here (came from V[p,i], not D[p,i])
  bit  9    insertion opened here (came from U[j,i-1])
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

# python float (not a jnp array): creating a device array at import
# time would initialise the XLA backend before jax.distributed can
# run in multi-host mode
BIG = 1e6

CODE_EDGE = 0
CODE_MATCH = 1
CODE_DEL = 2
CODE_INS = 3


@dataclass(frozen=True)
class DpParams:
    """Already-negated scheme values (align.cpp:406: the aligner hands
    -match/-mismatch to the minimising scheme)."""

    match: float = -2.0
    mismatch: float = 1.0
    gap_open: float = 5.0
    gap_ext: float = 2.0


@functools.partial(
    jax.jit,
    static_argnames=("n_nodes", "m_len", "params", "window"),
)
def poa_dp(
    node_pos,      # (N,) int32
    node_mask,     # (N,) int32 (uint8 widened)
    node_weight,   # (N,) float32
    preds,         # (N, P) int32, -1 = none
    is_start,      # (N,) bool
    is_end,        # (N,) bool
    qmask,         # (M,) int32
    qlen,          # () int32  actual query length
    n_real,        # () int32  actual node count
    col_weights,   # (Wpad,) float32 per-column weights (ones if simple)
    n_nodes: int,
    m_len: int,
    params: DpParams,
    window: int | None = None,
):
    """Graph-mode cost setup + DP.  Returns (bp (N, M) uint16,
    best_j, best_i, raw_score).  `window` selects the sliding-window
    core when every predecessor is within that topo distance."""
    N, M = n_nodes, m_len
    go, ge = jnp.float32(params.gap_open), jnp.float32(params.gap_ext)

    wcol = col_weights[node_pos]                      # (N,)
    wins = col_weights[jnp.minimum(node_pos + 1, col_weights.shape[0] - 1)]
    compat = (node_mask[:, None] & qmask[None, :] & 0xF) != 0  # (N, M)
    sub = jnp.where(
        compat, jnp.float32(params.match), jnp.float32(params.mismatch)
    ) * (wcol * node_weight)[:, None]                 # (N, M)
    if window is not None:
        return poa_dp_costs_windowed(
            sub, go * wcol, ge * wcol, go * wins, ge * wins,
            preds, is_start, is_end, qlen, n_real,
            n_nodes=N, m_len=M, window=window,
        )
    return poa_dp_costs(
        sub, go * wcol, ge * wcol, go * wins, ge * wins,
        preds, is_start, is_end, qlen, n_real,
        n_nodes=N, m_len=M,
    )


@functools.partial(
    jax.jit,
    static_argnames=("n_nodes", "m_len", "params", "window"),
)
def poa_dp_forbid(
    node_pos, node_mask, node_weight, preds, is_start, is_end,
    qmask, qlen, n_real, col_weights, max_insert,
    n_nodes: int, m_len: int, params: DpParams,
    window: int | None = None,
):
    """Graph-mode DP with the aspace-aware bounded insertion budget
    (--insertion=forbid, mesh.h:377-438)."""
    N, M = n_nodes, m_len
    go, ge = jnp.float32(params.gap_open), jnp.float32(params.gap_ext)
    wcol = col_weights[node_pos]
    wins = col_weights[jnp.minimum(node_pos + 1, col_weights.shape[0] - 1)]
    compat = (node_mask[:, None] & qmask[None, :] & 0xF) != 0
    sub = jnp.where(
        compat, jnp.float32(params.match), jnp.float32(params.mismatch)
    ) * (wcol * node_weight)[:, None]
    if window is not None:
        return poa_dp_costs_windowed(
            sub, go * wcol, ge * wcol, go * wins, ge * wins,
            preds, is_start, is_end, qlen, n_real,
            n_nodes=N, m_len=M, ins_budget=max_insert,
            window=window,
        )
    return poa_dp_costs(
        sub, go * wcol, ge * wcol, go * wins, ge * wins,
        preds, is_start, is_end, qlen, n_real,
        n_nodes=N, m_len=M, ins_budget=max_insert,
    )


@functools.partial(
    jax.jit, static_argnames=("n_nodes", "m_len", "params")
)
def poa_dp_subst(
    node_pos, node_mask, preds, is_start, is_end,
    qmask, qlen, n_real, col_weights, subst,
    n_nodes: int, m_len: int, params: DpParams,
    ins_budget=None,
):
    """Graph-mode DP under the experimental substitution-matrix
    scheme (scoring_scheme_matrix, scoring_schemes.h:244-311): match
    cost is the mean of subst[l, r] over the IUPAC letter pairs
    (aligned_base.h:176-215) times the column weight; gap costs are
    gp/gpe times the column weight; node weights are NOT applied."""
    N, M = n_nodes, m_len
    go, ge = jnp.float32(params.gap_open), jnp.float32(params.gap_ext)
    wcol = col_weights[node_pos]
    bits_n = [
        ((node_mask >> s) & 1).astype(jnp.float32) for s in range(4)
    ]                                                  # 4 x (N,)
    bits_q = [
        ((qmask >> s) & 1).astype(jnp.float32) for s in range(4)
    ]                                                  # 4 x (M,)
    # explicit per-letter sums: a fixed f32 op order
    numer = jnp.zeros((N, M), dtype=jnp.float32)
    pn = jnp.zeros((N,), dtype=jnp.float32)
    pq = jnp.zeros((M,), dtype=jnp.float32)
    for r in range(4):
        pq = pq + bits_q[r]
    for l in range(4):
        sq = jnp.zeros((M,), dtype=jnp.float32)
        for r in range(4):
            sq = sq + subst[l, r] * bits_q[r]
        numer = numer + bits_n[l][:, None] * sq[None, :]
        pn = pn + bits_n[l]
    denom = jnp.maximum(pn[:, None] * pq[None, :], 1.0)
    sub = (numer / denom) * wcol[:, None]
    return poa_dp_costs(
        sub, go * wcol, ge * wcol, go * wcol, ge * wcol,
        preds, is_start, is_end, qlen, n_real,
        n_nodes=N, m_len=M, ins_budget=ins_budget,
    )


@functools.lru_cache(maxsize=64)
def _batched_subst_fn(n_nodes: int, m_len: int, params: DpParams,
                      aspace: bool = False):
    def core(pos, mask, preds, st, en, qm, ql, nr, cw, subst,
             budget=None):
        bp, bj, bi, raw = poa_dp_subst(
            pos, mask, preds, st, en, qm, ql, nr, cw, subst,
            n_nodes=n_nodes, m_len=m_len, params=params,
            ins_budget=budget,
        )
        emit = traceback_device(bp, bj, bi, preds, st, n_nodes, m_len)
        return emit, bj, bi, raw

    if aspace:
        return jax.jit(jax.vmap(core))
    return jax.jit(jax.vmap(lambda *a: core(*a)))


def poa_dp_subst_batch(
    pos, mask, preds, is_start, is_end,
    qmask, qlen, n_real, col_weights, subst, params: DpParams,
    max_insert=None,
):
    """Batched substitution-matrix DP; `subst` is (B, 4, 4);
    `max_insert` (B, N) enables the bounded-insertion (forbid)
    transition."""
    fn = _batched_subst_fn(
        pos.shape[1], qmask.shape[1], params,
        aspace=max_insert is not None,
    )
    if max_insert is not None:
        return fn(
            pos, mask, preds, is_start, is_end,
            qmask, qlen, n_real, col_weights, subst, max_insert,
        )
    return fn(
        pos, mask, preds, is_start, is_end,
        qmask, qlen, n_real, col_weights, subst,
    )


def _windowed_min(W, R, M: int):
    """min over the trailing window [i-R+1, i] of W, per i, with a
    traced row-constant window length R (sparse-table doubling,
    aspace-aware insertion budget, mesh.h:403-437)."""
    levels = [W]
    n = 1
    while n < M:
        prev = levels[-1]
        shifted = jnp.concatenate(
            [jnp.full((n,), BIG), prev[:-n]]
        )
        levels.append(jnp.minimum(prev, shifted))
        n *= 2
    T = jnp.stack(levels)  # (L, M) T[s][i] = min W[i-2^s+1 .. i]
    L = T.shape[0]
    iidx = jnp.arange(M)
    Rc = jnp.clip(R, 1, M)
    out = jnp.full((M,), BIG)
    for s in range(L):
        size = 1 << s
        applies = (Rc >= size) & ((Rc < 2 * size) | (s == L - 1))
        a = T[s]
        # second interval covering [i-R+1, i-R+2^s]
        idx2 = jnp.clip(iidx - Rc + size, 0, M - 1)
        b = jnp.where(iidx - Rc + size >= 0, T[s][idx2], BIG)
        cand = jnp.minimum(a, b)
        out = jnp.where(applies, cand, out)
    return out


@functools.partial(
    jax.jit, static_argnames=("n_nodes", "m_len", "window")
)
def poa_dp_costs_windowed(
    sub, del_open, del_ext, ins_open, ins_ext,
    preds, is_start, is_end, qlen, n_real,
    n_nodes: int, m_len: int,
    ins_budget=None, window: int = 32,
):
    """Sliding-window variant of poa_dp_costs for graphs whose
    predecessors all sit within `window` topo positions (true for
    MSA-derived POA graphs — measured max distance 18 at fs-max=40).
    The scan carries only a (window, M) ring of V/D rows instead of
    the dense (N, M) lattices, pred rows are gathered from the ring,
    and backpointers stack as scan outputs.  Bit-identical results to
    poa_dp_costs (tested)."""
    N, M = n_nodes, m_len
    P = preds.shape[1]
    K = window

    iidx = jnp.arange(M, dtype=jnp.float32)
    pred_ok = preds >= 0
    dist = jnp.arange(N, dtype=jnp.int32)[:, None] - preds  # (N, P)

    Vr0 = jnp.full((K, M), BIG, dtype=jnp.float32)
    Dr0 = jnp.full((K, M), BIG, dtype=jnp.float32)
    carry0 = (
        Vr0, Dr0,
        jnp.float32(BIG), jnp.int32(0), jnp.int32(0),
    )
    budget_xs = (
        ins_budget
        if ins_budget is not None
        else jnp.zeros(N, dtype=jnp.int32)
    )
    xs = (
        sub, del_open, del_ext, ins_open, ins_ext,
        dist, pred_ok, is_start, is_end,
        jnp.arange(N, dtype=jnp.int32), budget_xs,
    )

    def step(carry, x):
        Vr, Dr, b2v, b2j, b2i = carry
        (subj, wd_o, wd_e, go_i, ge_i,
         dist_j, ok, start_j, end_j, j, budget_j) = x
        # exact row gather: a float32 matmul against a one-hot matrix
        # may run in TF32 on a GPU and round DP values
        ridx = jnp.mod(j - dist_j, K)              # (P,)
        Vp = jnp.where(ok[:, None], jnp.take(Vr, ridx, axis=0), BIG)
        Dp = jnp.where(ok[:, None], jnp.take(Dr, ridx, axis=0), BIG)

        edge = start_j | (jnp.arange(M) == 0)
        base = jnp.where(edge, jnp.float32(1.0), BIG)

        d_open_cand = Vp + wd_o
        d_ext_cand = Dp + wd_e
        dcand = jnp.minimum(d_open_cand, d_ext_cand)
        dslot = jnp.argmin(dcand, axis=0)
        dmin = dcand.min(axis=0)
        dsel_open = (
            jnp.take_along_axis(d_open_cand, dslot[None], 0)[0]
            < jnp.take_along_axis(d_ext_cand, dslot[None], 0)[0]
        )
        Drow = jnp.minimum(base, dmin)

        Vp_prev = jnp.concatenate(
            [jnp.full((P, 1), BIG), Vp[:, :-1]], axis=1
        )
        mslot = jnp.argmin(Vp_prev, axis=0)
        Mc = Vp_prev.min(axis=0) + subj

        U = base
        codeU = jnp.zeros(M, dtype=jnp.uint16)
        take_d = dmin < U
        U = jnp.where(take_d, dmin, U)
        codeU = jnp.where(take_d, jnp.uint16(CODE_DEL), codeU)
        take_m = Mc < U
        U = jnp.where(take_m, Mc, U)
        codeU = jnp.where(take_m, jnp.uint16(CODE_MATCH), codeU)

        cand = U + go_i - (iidx + 1.0) * ge_i
        if ins_budget is None:
            run = jax.lax.cummin(cand)
            seed = jnp.float32(1.0)
            prefix = jnp.concatenate(
                [seed[None], jnp.minimum(run[:-1], seed)]
            )
        else:
            wm = _windowed_min(cand, budget_j, M)
            prefix = jnp.concatenate([jnp.array([BIG]), wm[:-1]])
            prefix = jnp.where(budget_j < 1, BIG, prefix)
        Irow = prefix + iidx * ge_i
        Iprev = jnp.concatenate([jnp.array([BIG]), Irow[:-1]])
        Uprev = jnp.concatenate([jnp.array([BIG]), U[:-1]])
        ins_opened = (Uprev + go_i) <= (Iprev + ge_i)

        take_i = Irow <= U
        Vrow = jnp.where(take_i, Irow, U)
        code = jnp.where(take_i, jnp.uint16(CODE_INS), codeU)

        bp_row = (
            code
            | (mslot.astype(jnp.uint16) << 2)
            | (dslot.astype(jnp.uint16) << 5)
            | (dsel_open.astype(jnp.uint16) << 8)
            | (ins_opened.astype(jnp.uint16) << 9)
        )

        Vr = jax.lax.dynamic_update_slice(
            Vr, Vrow[None], (jnp.mod(j, K), 0)
        )
        Dr = jax.lax.dynamic_update_slice(
            Dr, Drow[None], (jnp.mod(j, K), 0)
        )
        # end-candidate 2 running row-major argmin (end nodes at any
        # slave position; strict < keeps the lowest j like the flat
        # argmin of poa_dp_costs)
        iok = jnp.arange(M) < qlen
        masked = jnp.where(
            end_j & (j < n_real) & iok, Vrow, BIG
        )
        i_at = jnp.argmin(masked)
        v_at = masked[i_at]
        upd = v_at < b2v
        b2v = jnp.where(upd, v_at, b2v)
        b2j = jnp.where(upd, j, b2j)
        b2i = jnp.where(upd, i_at.astype(jnp.int32), b2i)
        lastcol = Vrow[qlen - 1]
        return (Vr, Dr, b2v, b2j, b2i), (bp_row, lastcol)

    (_, _, v2, j2, i2), (BP, lastcols) = jax.lax.scan(
        step, carry0, xs
    )
    node_valid = jnp.arange(N) < n_real
    c1 = jnp.where(node_valid, lastcols, BIG)
    j1 = jnp.argmin(c1)
    v1 = c1[j1]
    use2 = v2 < v1                                  # strict (mesh.h:588)
    best_j = jnp.where(use2, j2, j1)
    best_i = jnp.where(use2, i2, qlen - 1)
    raw = jnp.where(use2, v2, v1)
    return BP, best_j, best_i, raw


@functools.partial(
    jax.jit, static_argnames=("n_nodes", "m_len", "return_lattice")
)
def poa_dp_costs(
    sub,           # (N, M) f32 substitution cost per (node, base)
    del_open,      # (N,) f32 deletion-open cost at node
    del_ext,       # (N,) f32 deletion-extend cost at node
    ins_open,      # (N,) f32 insertion-open cost at node
    ins_ext,       # (N,) f32 insertion-extend cost at node
    preds,         # (N, P) int32, -1 = none
    is_start,      # (N,) bool
    is_end,        # (N,) bool
    qlen,          # () int32  actual query length
    n_real,        # () int32  actual node count
    n_nodes: int,
    m_len: int,
    ins_budget=None,  # (N,) int32 bounded insertions (forbid mode)
    return_lattice: bool = False,
):
    """Cost-parameterised DP core shared by graph (mseq) and profile
    (pseq) modes.  Returns (bp (N, M) uint16, best_j, best_i, raw);
    with return_lattice also the final V and D (N, M) value planes
    (the --debug-lattice dump, mesh_debug.h:103-193's mesh data)."""
    N, M = n_nodes, m_len
    P = preds.shape[1]

    iidx = jnp.arange(M, dtype=jnp.float32)
    pred_row = preds + 1          # 0 = virtual BIG row
    pred_ok = preds >= 0

    V0 = jnp.full((N + 1, M), BIG, dtype=jnp.float32)
    D0 = jnp.full((N + 1, M), BIG, dtype=jnp.float32)
    BP0 = jnp.zeros((N, M), dtype=jnp.uint16)

    def body(j, carry):
        V, D, BP = carry
        pj = pred_row[j]                          # (P,)
        ok = pred_ok[j][:, None]                  # (P, 1)
        Vp = jnp.where(ok, V[pj], BIG)            # (P, M)
        Dp = jnp.where(ok, D[pj], BIG)

        edge = is_start[j] | (jnp.arange(M) == 0)
        base = jnp.where(edge, jnp.float32(1.0), BIG)  # (M,)

        wd_o = del_open[j]
        wd_e = del_ext[j]
        d_open_cand = Vp + wd_o                   # (P, M)
        d_ext_cand = Dp + wd_e
        dcand = jnp.minimum(d_open_cand, d_ext_cand)
        dslot = jnp.argmin(dcand, axis=0)         # (M,)
        dmin = dcand.min(axis=0)
        # tie: reference opens only on strict < (mesh.h:316-323)
        dsel_open = (
            jnp.take_along_axis(d_open_cand, dslot[None], 0)[0]
            < jnp.take_along_axis(d_ext_cand, dslot[None], 0)[0]
        )
        Drow = jnp.minimum(base, dmin)

        Vp_prev = jnp.concatenate(
            [jnp.full((P, 1), BIG), Vp[:, :-1]], axis=1
        )                                          # (P, M) V[p, i-1]
        mslot = jnp.argmin(Vp_prev, axis=0)
        Mc = Vp_prev.min(axis=0) + sub[j]

        # U with reference tie priority: edge keeps ties vs D; M strict
        U = base
        codeU = jnp.zeros(M, dtype=jnp.uint16)
        take_d = dmin < U
        U = jnp.where(take_d, dmin, U)
        codeU = jnp.where(take_d, jnp.uint16(CODE_DEL), codeU)
        take_m = Mc < U
        U = jnp.where(take_m, Mc, U)
        codeU = jnp.where(take_m, jnp.uint16(CODE_MATCH), codeU)

        # insertion track, closed form:
        # I[i] = i*ge' + min(base[0], min_{k<i}(U[k] + go' - (k+1)*ge'))
        go_i = ins_open[j]
        ge_i = ins_ext[j]
        cand = U + go_i - (iidx + 1.0) * ge_i
        if ins_budget is None:
            run = jax.lax.cummin(cand)
            seed = jnp.float32(1.0)  # I[j,0] edge value
            prefix = jnp.concatenate(
                [seed[None], jnp.minimum(run[:-1], seed)]
            )
        else:
            # bounded runs, no edge seed (mesh.h:403-437)
            wm = _windowed_min(cand, ins_budget[j], M)
            prefix = jnp.concatenate([jnp.array([BIG]), wm[:-1]])
            prefix = jnp.where(ins_budget[j] < 1, BIG, prefix)
        Irow = prefix + iidx * ge_i
        # opened at i (vs extended): U[i-1]+go <= I[i-1]+ge
        Iprev = jnp.concatenate([jnp.array([BIG]), Irow[:-1]])
        Uprev = jnp.concatenate([jnp.array([BIG]), U[:-1]])
        ins_opened = (Uprev + go_i) <= (Iprev + ge_i)

        take_i = Irow <= U                         # ties -> insertion
        Vrow = jnp.where(take_i, Irow, U)
        code = jnp.where(take_i, jnp.uint16(CODE_INS), codeU)

        bp_row = (
            code
            | (mslot.astype(jnp.uint16) << 2)
            | (dslot.astype(jnp.uint16) << 5)
            | (dsel_open.astype(jnp.uint16) << 8)
            | (ins_opened.astype(jnp.uint16) << 9)
        )

        V = jax.lax.dynamic_update_slice(V, Vrow[None], (j + 1, 0))
        D = jax.lax.dynamic_update_slice(D, Drow[None], (j + 1, 0))
        BP = jax.lax.dynamic_update_slice(BP, bp_row[None], (j, 0))
        return V, D, BP

    V, D, BP = jax.lax.fori_loop(0, N, body, (V0, D0, BP0))
    Vm = V[1:]                                     # (N, M)

    node_valid = jnp.arange(N) < n_real
    # candidate 1: every node at the last real slave base
    # (mesh.h:569-578)
    last_col = jnp.take_along_axis(
        Vm, jnp.full((N, 1), qlen - 1, dtype=jnp.int32), axis=1
    )[:, 0]
    c1 = jnp.where(node_valid, last_col, BIG)
    j1 = jnp.argmin(c1)
    v1 = c1[j1]
    # candidate 2: end nodes at every slave position (mesh.h:580-592)
    iok = jnp.arange(M) < qlen
    c2 = jnp.where(
        (is_end & node_valid)[:, None] & iok[None, :], Vm, BIG
    )
    flat = jnp.argmin(c2)
    j2, i2 = flat // M, flat % M
    v2 = c2[j2, i2]
    use2 = v2 < v1                                  # strict (mesh.h:588)
    best_j = jnp.where(use2, j2, j1)
    best_i = jnp.where(use2, i2, qlen - 1)
    raw = jnp.where(use2, v2, v1)
    if return_lattice:
        return BP, best_j, best_i, raw, Vm, D[1:]
    return BP, best_j, best_i, raw


@functools.lru_cache(maxsize=64)
def _batched_fn(
    n_nodes: int, m_len: int, params: DpParams,
    aspace: bool = False, window: int | None = None,
):
    """Compiled vmapped DP + on-device traceback for one shape bucket.
    Only the per-base emission array leaves the device; the V/D/BP
    lattices live and die in HBM."""

    def core(pos, mask, w, preds, st, en, qm, ql, nr, cw,
             max_ins=None):
        if aspace:
            bp, bj, bi, raw = poa_dp_forbid(
                pos, mask, w, preds, st, en, qm, ql, nr, cw,
                max_ins, n_nodes=n_nodes, m_len=m_len, params=params,
                window=window,
            )
        else:
            bp, bj, bi, raw = poa_dp(
                pos, mask, w, preds, st, en, qm, ql, nr, cw,
                n_nodes=n_nodes, m_len=m_len, params=params,
                window=window,
            )
        emit = traceback_device(
            bp, bj, bi, preds, st, n_nodes, m_len
        )
        return emit, bj, bi, raw

    if aspace:
        return jax.jit(jax.vmap(core))
    return jax.jit(
        jax.vmap(lambda *a: core(*a))
    )


def poa_dp_batch(
    pos, mask, weight, preds, is_start, is_end,
    qmask, qlen, n_real, col_weights, params: DpParams,
    max_insert=None, window: int | None = None,
):
    """Batched DP over stacked padded graphs/queries: leading batch
    axis on every array argument.  Returns (emit (B, M), best_j,
    best_i, raw).  `max_insert` (B, N) enables forbid mode; `window`
    selects the sliding-window core (all preds within that topo
    distance)."""
    fn = _batched_fn(
        pos.shape[1], qmask.shape[1], params,
        aspace=max_insert is not None, window=window,
    )
    if max_insert is not None:
        return fn(
            pos, mask, weight, preds, is_start, is_end,
            qmask, qlen, n_real, col_weights, max_insert,
        )
    return fn(
        pos, mask, weight, preds, is_start, is_end,
        qmask, qlen, n_real, col_weights,
    )


def emit_to_pairs(emit: np.ndarray) -> tuple[list, int]:
    """Convert a device emission row to ([(node, slave_i)], head)."""
    idx = np.nonzero(emit >= 0)[0]
    pairs = [(int(emit[i]), int(i)) for i in idx]
    head = int(idx[0]) if len(idx) else 0
    return pairs, head


# device traceback state machine states
_S_RESOLVE = 0       # check for deletion-valued cell, then emit
_S_CHAIN = 1         # following a deletion chain (emit after)
_S_DECIDE = 2        # base i emitted; decode next move
_S_INS = 3           # inside an insertion run
_S_RESOLVE_NE = 4    # resolve without emitting (post-insertion)
_S_CHAIN_NE = 5      # chain without emitting
_S_DONE = 6


def traceback_device(bp, best_j, best_i, preds, is_start, n_nodes: int,
                     m_len: int):
    """On-device traceback: returns emit (M,) int32 with the node id
    consuming each slave base (-1 = not consumed / overhang).  Same
    semantics as the host `traceback`; runs as a while_loop so the
    backpointer lattice never leaves the device."""
    M = m_len

    def cond(c):
        return c[3] != _S_DONE

    def body(c):
        j, i, emit, state = c
        cell = bp[j, i].astype(jnp.int32)
        code = cell & 0x3
        mslot = (cell >> 2) & 0x7
        dslot = (cell >> 5) & 0x7
        dopen = (cell >> 8) & 1
        iopen = (cell >> 9) & 1
        at_edge = (i == 0) | is_start[j]

        def mk_resolve(emitting):
            def s_resolve(_):
                is_del = (code == CODE_DEL) & ~at_edge
                chain = _S_CHAIN if emitting else _S_CHAIN_NE
                if emitting:
                    nxt_emit = jnp.where(
                        is_del, emit, emit.at[i].set(j)
                    )
                else:
                    nxt_emit = emit
                ns = jnp.where(is_del, chain, _S_DECIDE)
                return j, i, nxt_emit, ns
            return s_resolve

        def mk_chain(emitting):
            def s_chain(_):
                pj = preds[j, dslot]
                pj = jnp.where(pj < 0, j, pj)  # safety
                stop = (dopen == 1) | is_start[pj]
                resolve = _S_RESOLVE if emitting else _S_RESOLVE_NE
                chain = _S_CHAIN if emitting else _S_CHAIN_NE
                return pj, i, emit, jnp.where(stop, resolve, chain)
            return s_chain

        def s_decide(_):
            done = at_edge | (code == CODE_EDGE)
            is_m = code == CODE_MATCH
            is_i = code == CODE_INS
            pj = preds[j, mslot]
            pj = jnp.where(pj < 0, j, pj)
            nj = jnp.where(is_m & ~done, pj, j)
            ni = jnp.where(is_m & ~done, i - 1, i)
            ns = jnp.where(
                done, _S_DONE,
                jnp.where(
                    is_m, _S_RESOLVE,
                    jnp.where(is_i, _S_INS, _S_CHAIN_NE),
                ),
            )
            return nj, ni, emit, ns

        def s_ins(_):
            ni = i - 1
            done = ni < 0
            safe = jnp.maximum(ni, 0)
            nxt_emit = jnp.where(done, emit, emit.at[safe].set(j))
            ns = jnp.where(
                done, _S_DONE,
                jnp.where(iopen == 1, _S_DECIDE, _S_INS),
            )
            return j, safe, nxt_emit, ns

        return jax.lax.switch(
            state,
            [
                mk_resolve(True), mk_chain(True), s_decide, s_ins,
                mk_resolve(False), mk_chain(False),
            ],
            None,
        )

    emit0 = jnp.full((M,), -1, dtype=jnp.int32)
    j0 = best_j.astype(jnp.int32)
    i0 = best_i.astype(jnp.int32)
    j, i, emit, state = jax.lax.while_loop(
        cond, body, (j0, i0, emit0, jnp.int32(_S_RESOLVE))
    )
    return emit


def traceback(
    bp: np.ndarray,
    best_j: int,
    best_i: int,
    node_pos: np.ndarray,
    preds: np.ndarray,
    is_start: np.ndarray,
) -> list[tuple[int, int]]:
    """Walk packed backpointers; returns [(node_or_-1, slave_i)] in
    left-to-right slave order.  node -1 marks left-overhang bases (the
    walk ended before slave position 0).  Inserted bases report the
    anchor node (they share its column; the NAST shift later spreads
    them, mesh.h:642-685 semantics)."""
    def resolve(j: int, i: int) -> int:
        """Follow deletion-valued cells back to the node where slave
        base i is actually consumed (the reference's skip-cell logic,
        mesh.h:648-655, generalised to chained deletions)."""
        while not (is_start[j] or i == 0):
            if int(bp[j, i]) & 0x3 != CODE_DEL:
                break
            # follow this cell's deletion chain to its opening
            while True:
                cell = int(bp[j, i])
                slot = (cell >> 5) & 0x7
                opened = (cell >> 8) & 1
                j = int(preds[j, slot])
                if opened or is_start[j]:
                    break
        return j

    out = []  # (slave_i, node_j) emitted right-to-left
    j, i = int(best_j), int(best_i)
    j = resolve(j, i)
    out.append((i, j))
    while not (i == 0 or is_start[j]):
        cell = int(bp[j, i])
        c = cell & 0x3
        if c == CODE_EDGE:
            break  # free start: remaining bases are left overhang
        if c == CODE_DEL:
            # reached e.g. after an insertion run whose anchor's value
            # came from the deletion track: hop back, no emission (the
            # anchor was already emitted at the insertion node, as in
            # the reference, mesh.h:664-684)
            j = resolve(j, i)
            continue
        if c == CODE_MATCH:
            slot = (cell >> 2) & 0x7
            j = int(preds[j, slot])
            i -= 1
            j = resolve(j, i)
            out.append((i, j))
        else:  # CODE_INS: run of inserted bases anchored at node j
            while True:
                opened = (int(bp[j, i]) >> 9) & 1
                i -= 1
                if i < 0:
                    break
                out.append((i, j))
                if opened:
                    break
            if i < 0:
                break
            # anchor consumed at j; continue main loop from (j, i)
    head = out[-1][0]  # leftmost emitted slave index
    return [(j, i) for (i, j) in reversed(out)], head
