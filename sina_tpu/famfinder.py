"""Reference (family) selection stage.

Port of the semantics of famfinder
(/root/reference/src/famfinder.cpp:270-612): orientation ("turn")
check via 4-way index probing, constraint-driven family selection with
escalating retry, gap-count filtering and alignment-stats selection.
Scoring runs batched on device (ops/kmer_kernel); the policy layer is
host-side python over small top-k lists.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from .comparator import Comparator, IUPAC_OPTIMISTIC, COVER_QUERY
from .timing import get_timer
from .ops.kmer import query_kmers_padded
from .ops.kmer_index import KmerIndex
from .ops.kmer_kernel import kmer_scores
from .refdb import ReferenceDb
from .sequence import Sequence

logger = logging.getLogger("sina.famfinder")


import functools as _functools


@_functools.lru_cache(maxsize=8)
def _score_topk_compiled(k: int):
    import jax
    import jax.numpy as jnp

    from .ops.kmer_kernel import grouped_top_k

    def fn(P, kmers):
        scores = kmer_scores(P, kmers)
        if scores.shape[1] >= 32768:
            # SILVA scale: lax.top_k over the full sequence axis
            # is a large share of the step; the group-max
            # hierarchy is exact (values provably identical) and
            # 8x narrower
            vals, ids = grouped_top_k(scores, k)
        else:
            vals, ids = jax.lax.top_k(scores, k)
        # single packed output = single device->host round-trip
        return jnp.concatenate([vals, ids], axis=1)

    return jax.jit(fn)


def _score_topk_jit(P, kmers, k: int):
    packed = np.asarray(_score_topk_compiled(k)(P, kmers))
    return packed[:, :k], packed[:, k:]


TURN_NONE = "none"
TURN_REVCOMP = "revcomp"
TURN_ALL = "all"


@dataclass
class FamFinderConfig:
    turn: str = TURN_NONE
    fs_kmer_len: int = 10
    fs_no_fast: bool = False
    fs_min: int = 40
    fs_max: int = 40
    fs_msc: float = 0.7
    fs_msc_max: float = 2.0
    fs_leave_query_out: bool = False
    fs_req: int = 1
    fs_req_full: int = 1
    fs_full_len: int = 1400
    fs_req_gaps: int = 10
    fs_min_len: int = 150
    fs_cover_gene: int = 0
    gene_start: int = 0
    gene_end: int = 0
    posvar_filter: str = ""
    posvar_autofilter_field: str = ""
    posvar_autofilter_thres: float = 0.8


@dataclass
class FamilyResult:
    family: list[tuple[float, Sequence]]
    astats_name: str = ""
    astats_weights: np.ndarray | None = None
    log: list[str] = field(default_factory=list)
    failed: bool = False


class FamFinder:
    def __init__(self, db: ReferenceDb, cfg: FamFinderConfig | None = None):
        self.db = db
        self.cfg = cfg or FamFinderConfig()
        db.ensure_flat()  # batch profile build gathers flat arrays
        self.index = KmerIndex.build(
            db, k=self.cfg.fs_kmer_len, fast=not self.cfg.fs_no_fast
        )
        self._P = None
        self._mesh = None
        self._sharded_fns: dict[int, object] = {}

    # -- device scoring ----------------------------------------------

    def _matrix(self):
        if self._P is None:
            import jax

            from .backend import local_devices

            multiproc = jax.process_count() > 1
            # multi-host runs are data-parallel by input shard (each
            # process reads its own --fasta-block): the index mesh is
            # host-local, all local devices as index ("mp") shards
            devices = local_devices()
            if len(devices) > 1:
                # shard the index over reference sequences (mp) and
                # query batches over dp; per-shard top-k merges via
                # all-gather (parallel/sharding.py)
                from .parallel.sharding import (
                    make_mesh, shard_index_matrix,
                )
                import jax.numpy as jnp

                self._mesh = make_mesh(
                    devices, dp=1 if multiproc else None
                )
                mp = self._mesh.shape["mp"]
                P = self.index.dense_packed()
                Sb = P.shape[1]
                Sb_pad = -(-Sb // mp) * mp
                if Sb_pad != Sb:
                    P = np.pad(P, ((0, 0), (0, Sb_pad - Sb)))
                # hand device_put the HOST array: jnp.asarray first
                # would commit the full matrix to device 0 before the
                # sharded placement
                self._P = shard_index_matrix(self._mesh, P)
            else:
                self._P = self.index.device_matrix()
        return self._P

    @staticmethod
    def _pad_rows(kmers: np.ndarray, sink: int) -> np.ndarray:
        """Pad the batch axis to a compile bucket (the row count is a
        traced shape dim; distinct values cost a fresh compile each —
        see ops.profile._bucket_rows).  Padded rows
        point every k-mer at the sink row, scoring 0 everywhere."""
        from .ops.profile import _bucket_rows

        B = kmers.shape[0]
        B_pad = _bucket_rows(B)
        if B_pad == B:
            return kmers
        return np.pad(
            kmers, ((0, B_pad - B), (0, 0)), constant_values=sink
        )

    def score_batch(self, mask_list: list[np.ndarray]) -> np.ndarray:
        """Raw k-mer hit counts (B, n_seqs) for a batch of queries."""
        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            kmers, _ = query_kmers_padded(
                mask_list, self.index.k, fast=self.index.fast
            )
        with t.section("score+fetch"):
            B = kmers.shape[0]
            kmers = self._pad_rows(
                kmers, self._matrix().shape[0] - 1
            )
            scores = np.asarray(kmer_scores(self._matrix(), kmers))
            return scores[:B, : self.index.n_seqs]

    def score_topk(
        self, mask_list: list[np.ndarray], k: int
    ) -> tuple[np.ndarray, np.ndarray]:
        """Device-side scoring + top-k: only the (B, k) candidate
        lists cross the host link (the all-gather merge point in the
        sharded path).  Ties resolve to the lowest id (deviation from
        kmer_search.cpp:412 which prefers the highest)."""
        import jax

        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            kmers, _ = query_kmers_padded(
                mask_list, self.index.k, fast=self.index.fast
            )
        k = min(k, self.index.n_seqs)
        with t.section("score+topk"):
            P = self._matrix()
            if self._mesh is not None:
                from .parallel.sharding import sharded_search
                import jax

                if k not in self._sharded_fns:
                    self._sharded_fns[k] = sharded_search(
                        self._mesh, k
                    )
                dp = self._mesh.shape["dp"]
                B = kmers.shape[0]
                # row-bucket first (per-batch row counts would mint
                # a fresh shard_map trace per batch), then pad to a
                # dp multiple for the mesh split
                kmers = self._pad_rows(kmers, P.shape[0] - 1)
                B_pad = -(-kmers.shape[0] // dp) * dp
                if B_pad != kmers.shape[0]:
                    kmers = np.pad(
                        kmers,
                        ((0, B_pad - kmers.shape[0]), (0, 0)),
                        constant_values=P.shape[0] - 1,
                    )
                vals, ids = self._sharded_fns[k](
                    P, jax.numpy.asarray(kmers)
                )
                vals = np.asarray(vals)[:B]
                ids = np.asarray(ids)[:B]
                # sink candidates pointing at seq-axis padding
                pad = ids >= self.index.n_seqs
                vals = np.where(pad, -1, vals)
                ids = np.where(pad, 0, ids)
                return vals, ids
            B = kmers.shape[0]
            kmers = self._pad_rows(kmers, P.shape[0] - 1)
            vals, ids = _score_topk_jit(P, kmers, k)
            vals, ids = vals[:B], ids[:B]
            pad = ids >= self.index.n_seqs
            vals = np.where(pad, -1, vals)
            ids = np.where(pad, 0, ids)
            return vals, ids

    def _seq_stats(self):
        """Per-sequence (lengths, first position, last position)
        arrays over the whole db — the vectorized _filter's inputs
        (one gather instead of 256 Sequence-object attribute chains
        per query; the per-candidate python loop was ~0.1 s/batch of
        the r5 100k steady state)."""
        if getattr(self, "_stats", None) is None:
            offsets, flat_pos, _ = self.db.flat_arrays()
            lens = np.diff(offsets)
            n = len(lens)
            pos0 = np.zeros(n, np.int64)
            posN = np.full(n, -1, np.int64)
            nz = lens > 0
            pos0[nz] = flat_pos[offsets[:-1][nz]]
            posN[nz] = flat_pos[(offsets[1:] - 1)[nz]]
            self._stats = (lens, pos0, posN)
        return self._stats

    def _filter_fast(self, vals, ids, limit: int):
        """Vectorized _filter (famfinder.cpp:541-588 semantics) for
        configs where no per-candidate Sequence object is needed:
        fs_leave_query_out off and fs_msc_max inert (>= 1.0, so the
        comparator can never remove anything — see _filter).  Returns
        (kept [(score, seq_id)], have, have_full, cover_l, cover_r).

        Unlike the reference's loop this breaks early once no later
        candidate can be kept (have >= fs_max with every quota met) —
        decision-equivalent because from that state every branch
        `continue`s without touching state."""
        cfg = self.cfg
        lens, pos0, posN = self._seq_stats()
        # drop invalid (-1 padding) BEFORE the limit slice, like the
        # object path's ranked-list construction: padding rows can
        # interleave with real zero-score candidates at the tie floor
        valid = vals >= 0
        if not valid.all():
            vals = vals[valid]
            ids = ids[valid]
        vals = vals[:limit]
        ids = ids[:limit]
        l = lens[ids]
        keepable = l >= cfg.fs_min_len
        is_full = l >= cfg.fs_full_len
        nz = l > 0
        covers_l = nz & (pos0[ids] <= cfg.gene_start)
        covers_r = nz & (posN[ids] >= cfg.gene_end)
        kept: list[tuple[float, int]] = []
        have = have_full = cover_l = cover_r = 0
        rows = zip(
            vals.tolist(), ids.tolist(), keepable.tolist(),
            is_full.tolist(), covers_l.tolist(), covers_r.tolist(),
        )
        for score, sid, ok, full, cl, cr in rows:
            if not ok:
                continue
            if have >= cfg.fs_min:
                score_keeps = score < cfg.fs_msc
                fills_full = (
                    cfg.fs_req_full
                    and have_full < cfg.fs_req_full
                    and full
                )
                fills_range = cfg.fs_cover_gene and (
                    (cover_r < cfg.fs_cover_gene and cr)
                    or (cover_l < cfg.fs_cover_gene and cl)
                )
                if (
                    (have >= cfg.fs_max or not score_keeps)
                    and not fills_full
                    and not fills_range
                ):
                    if (
                        have >= cfg.fs_max
                        and have_full >= cfg.fs_req_full
                        and cover_l >= cfg.fs_cover_gene
                        and cover_r >= cfg.fs_cover_gene
                    ):
                        break  # no later candidate can be kept
                    continue
            have += 1
            if full:
                have_full += 1
            if cl:
                cover_l += 1
            if cr:
                cover_r += 1
            kept.append((score, sid))
        return kept, have, have_full, cover_l, cover_r

    def _match_fast(
        self, vals: np.ndarray, ids: np.ndarray
    ) -> list[tuple[float, Sequence]] | None:
        """match() over numpy top-k rows (the batched path): same
        constraint-escalation protocol, Sequence objects materialised
        only for the kept family.  Returns None when the candidate
        rows ran out (the caller refetches deeper or defers to the
        batched escalation)."""
        cfg = self.cfg
        n = self.index.n_seqs
        avail = int((vals >= 0).sum())
        max_results = cfg.fs_max + 1
        while True:
            if avail < min(max_results, n):
                return None  # caller escalates with a deeper top-k
            kept, have, have_full, cl, cr = self._filter_fast(
                vals, ids, max_results
            )
            if (
                have >= cfg.fs_max
                and have_full >= cfg.fs_req_full
                and cl >= cfg.fs_cover_gene
                and cr >= cfg.fs_cover_gene
            ):
                break
            if max_results >= n:
                break
            max_results *= 10
        seqs = self.db.sequences
        return [(score, seqs[sid]) for score, sid in kept]

    def _fast_policy_ok(self) -> bool:
        """The vectorized filter applies when no per-candidate
        Sequence object is consulted: leave-query-out needs names,
        an active fs_msc_max (< 1.0) needs the comparator."""
        return (
            not self.cfg.fs_leave_query_out
            and self.cfg.fs_msc_max >= 1.0
        )

    def find(
        self, query: Sequence, max_results: int
    ) -> list[tuple[float, int]]:
        """Ranked [(score, seq_id)] for one query
        (kmer_search.cpp:366-420)."""
        scores = self.score_batch([query.masks])[0]
        return self._rank(scores, max_results)

    def _rank(self, scores: np.ndarray, max_results: int):
        max_results = min(max_results, len(scores))
        # descending score; reference breaks ties by higher id
        # (std::greater on (score,id) pairs, kmer_search.cpp:412)
        order = np.lexsort((-np.arange(len(scores)), -scores))
        top = order[:max_results]
        return [(float(scores[i]), int(i)) for i in top]

    # -- turn check ---------------------------------------------------

    def turn_check(self, query: Sequence, all4: bool) -> int:
        """0=asis 1=reversed 2=complemented 3=revcomp
        (famfinder.cpp:344-378)."""
        variants = [query.masks]
        rev = query.copy().reverse()
        comp = query.copy().complement()
        revcomp = query.copy().reverse().complement()
        if all4:
            variants += [rev.masks, comp.masks, revcomp.masks]
            order = [0, 1, 2, 3]
        else:
            variants += [revcomp.masks]
            order = [0, 3]
        scores = self.score_batch(variants)
        tops = scores.max(axis=1)
        best, best_score = 0, 0.0
        for k, oi in enumerate(order):
            if tops[k] > best_score:
                best_score = float(tops[k])
                best = oi
        return best

    def apply_turn(self, query: Sequence) -> Sequence:
        cfg = self.cfg
        if cfg.turn == TURN_NONE:
            query.set_attr("turn_slv", "turn-check disabled")
            return query
        which = self.turn_check(query, cfg.turn == TURN_ALL)
        if which == 0:
            query.set_attr("turn_slv", "none")
        elif which == 1:
            query.set_attr("turn_slv", "reversed")
            query.reverse()
        elif which == 2:
            query.set_attr("turn_slv", "complemented")
            query.complement()
        else:
            query.set_attr("turn_slv", "reversed and complemented")
            query.reverse().complement()
        return query

    # -- family selection policy --------------------------------------

    def match(
        self,
        query: Sequence,
        scores: np.ndarray | None = None,
        ranked: list[tuple[float, int]] | None = None,
        allow_refetch: bool = True,
    ) -> list[tuple[float, Sequence]] | None:
        """Constraint-driven family selection (famfinder.cpp:497-612).
        Either full `scores` or a pre-ranked candidate list may be
        given (batched path); escalation refetches when the candidate
        list runs out.  With allow_refetch=False the refetch is
        signalled by returning None instead, so process_batch can
        batch all escalating queries into ONE device scoring call."""
        cfg = self.cfg
        cmp = Comparator(IUPAC_OPTIMISTIC, "none", COVER_QUERY, False)
        qbases = query.get_bases().upper().replace("U", "T")

        max_results = cfg.fs_max + 1
        n = self.index.n_seqs
        while True:
            if ranked is not None and len(ranked) >= min(
                max_results, n
            ):
                cand = ranked[:max_results]
            else:
                if scores is None:
                    if not allow_refetch:
                        return None
                    scores = self.score_batch([query.masks])[0]
                cand = self._rank(scores, max_results)
                ranked = None
            kept = self._filter(cand, query, qbases, cmp)
            have, have_full, cl, cr = self._tally(kept)
            if (
                have >= cfg.fs_max
                and have_full >= cfg.fs_req_full
                and cl >= cfg.fs_cover_gene
                and cr >= cfg.fs_cover_gene
            ):
                break
            if max_results >= n:
                break
            max_results *= 10
        return kept

    def _is_full(self, seq: Sequence) -> bool:
        return len(seq) >= self.cfg.fs_full_len

    def _covers_left(self, seq: Sequence) -> bool:
        return (
            len(seq) > 0
            and int(seq.positions[0]) <= self.cfg.gene_start
        )

    def _covers_right(self, seq: Sequence) -> bool:
        return (
            len(seq) > 0
            and int(seq.positions[-1]) >= self.cfg.gene_end
        )

    def _tally(self, kept):
        have = len(kept)
        have_full = sum(1 for _, s in kept if self._is_full(s))
        cl = sum(1 for _, s in kept if self._covers_left(s))
        cr = sum(1 for _, s in kept if self._covers_right(s))
        return have, have_full, cl, cr

    def _filter(self, ranked, query, qbases, cmp):
        cfg = self.cfg
        kept: list[tuple[float, Sequence]] = []
        have = have_full = cover_l = cover_r = 0
        for score, sid in ranked:
            seq = self.db.sequences[sid]
            if len(seq) < cfg.fs_min_len:
                continue
            if cfg.fs_leave_query_out and seq.name == query.name:
                continue
            # the reference evaluates the comparator whenever
            # max_score <= 2 (famfinder.cpp:555), but identities are
            # <= 1, so thresholds above 1 can never remove anything —
            # skip the (expensive) comparison then
            if cfg.fs_msc_max < 1.0 and (
                cmp(query, seq) > cfg.fs_msc_max
            ):
                continue
            # beyond fs-min, the reference keeps only items whose score
            # is below fs-msc plus quota-fillers (famfinder.cpp:578-588;
            # reproduced as written — inert at default fs-min == fs-max)
            if have >= cfg.fs_min:
                score_keeps = score < cfg.fs_msc
                fills_full = (
                    cfg.fs_req_full
                    and have_full < cfg.fs_req_full
                    and self._is_full(seq)
                )
                fills_range = cfg.fs_cover_gene and (
                    (cover_r < cfg.fs_cover_gene and self._covers_right(seq))
                    or (cover_l < cfg.fs_cover_gene and self._covers_left(seq))
                )
                if (
                    (have >= cfg.fs_max or not score_keeps)
                    and not fills_full
                    and not fills_range
                ):
                    continue
            have += 1
            if self._is_full(seq):
                have_full += 1
            if self._covers_left(seq):
                cover_l += 1
            if self._covers_right(seq):
                cover_r += 1
            kept.append((score, seq))
        return kept

    # -- astats selection ---------------------------------------------

    def select_astats(
        self, family: list[tuple[float, Sequence]]
    ) -> tuple[str, np.ndarray | None, list[str]]:
        """Filter/quorum-vote alignment-stats selection
        (famfinder.cpp:381-436).  Returns (name, weights, log)."""
        from .stats import compute_weights

        cfg = self.cfg
        log: list[str] = []
        chosen = None
        if cfg.posvar_filter:
            for a in self.db.astats:
                if a["name"] in (
                    cfg.posvar_filter,
                    cfg.posvar_filter + ":ALL",
                    cfg.posvar_filter + ":all",
                ):
                    chosen = a
        if cfg.posvar_autofilter_field:
            best, best_count = None, 0
            for a in self.db.astats:
                n = 0
                for _, r in family:
                    f = (
                        cfg.posvar_filter
                        + ":"
                        + str(r.get_attr(cfg.posvar_autofilter_field, ""))
                    )
                    if f.lower().startswith(a["name"].lower()):
                        n += 1
                if n > best_count:
                    best, best_count = a, n
            if best is not None and best_count > len(family) * (
                cfg.posvar_autofilter_thres
            ):
                log.append(f"autofilter: {best['name']};")
                chosen = best
            else:
                log.append("autofilter: no match;")
        if chosen is None:
            return "", None, log
        return chosen["name"], compute_weights(chosen), log

    # -- full stage ---------------------------------------------------

    @staticmethod
    def _dedupe_masks(
        mask_list: list[np.ndarray],
    ) -> tuple[list[np.ndarray], np.ndarray]:
        """Collapse base-identical queries to one scoring row each
        (the reference keeps a FIFO result cache keyed on query
        bases, kmer_search.cpp:105,378 — dereplicated amplicon reads
        repeat verbatim).  Returns (unique mask list, inverse map
        batch-row -> unique-row)."""
        seen: dict[bytes, int] = {}
        inv = np.empty(len(mask_list), dtype=np.int64)
        uniq: list[np.ndarray] = []
        for i, m in enumerate(mask_list):
            key = m.tobytes()
            j = seen.get(key)
            if j is None:
                j = seen[key] = len(uniq)
                uniq.append(m)
            inv[i] = j
        return uniq, inv

    def submit_batch(self, queries: list[Sequence]):
        """Dispatch the device scoring for a batch WITHOUT fetching,
        so callers can overlap it with other device/host work; pass
        the handle to process_batch(queries, handle=...)."""
        cfg = self.cfg
        if not queries or cfg.turn != TURN_NONE:
            return None  # turn path fetches eagerly
        t = get_timer("Kmer Search")
        with t.section("extract kmers"):
            uniq, inv = self._dedupe_masks([q.masks for q in queries])
            kmers, _ = query_kmers_padded(
                uniq, self.index.k, fast=self.index.fast,
            )
            P = self._matrix()
            # row-bucket pad so neither dedupe nor a short batch
            # mints a new device shape — the sharded fn's traced
            # shapes vary with the row count exactly like the jit's
            kmers = self._pad_rows(kmers, P.shape[0] - 1)
        k0 = min(
            max(4 * cfg.fs_max + 16, 256), self.index.n_seqs
        )
        with t.section("score dispatch"):
            if self._mesh is not None:
                # sharded dispatch: same handle protocol, so the
                # 3-deep pipeline overlaps identically on a mesh
                from .parallel.sharding import sharded_search
                import jax

                if k0 not in self._sharded_fns:
                    self._sharded_fns[k0] = sharded_search(
                        self._mesh, k0
                    )
                dp = self._mesh.shape["dp"]
                B = kmers.shape[0]  # already row-bucketed above
                B_pad = -(-B // dp) * dp
                if B_pad != B:
                    kmers = np.pad(
                        kmers, ((0, B_pad - B), (0, 0)),
                        constant_values=P.shape[0] - 1,
                    )
                vals, ids = self._sharded_fns[k0](
                    P, jax.numpy.asarray(kmers)
                )
                return (vals, ids, len(uniq)), k0, inv
            handle = _score_topk_compiled(k0)(P, kmers)
        return handle, k0, inv

    def process_batch(
        self, queries: list[Sequence], handle=None
    ) -> list[FamilyResult]:
        """Batched famfinder: one device call scores every query (and
        every turn-check orientation); the per-query policy runs on
        the host over the returned score rows."""
        cfg = self.cfg
        B = len(queries)
        if B == 0:
            return []
        if handle is not None:
            packed, k0, inv = handle
            t = get_timer("Kmer Search")
            with t.section("fetch topk"):
                if isinstance(packed, tuple):  # sharded (vals, ids)
                    dv, di, Bu = packed
                    vals = np.asarray(dv)[:Bu]
                    ids = np.asarray(di)[:Bu]
                else:
                    packed = np.asarray(packed)
                    vals, ids = packed[:, :k0], packed[:, k0:]
            with t.section("policy"):
                pad = ids >= self.index.n_seqs
                vals = np.where(pad, -1, vals)
                ids = np.where(pad, 0, ids)
                out = []
                for b, q in enumerate(queries):
                    q.set_attr("turn_slv", "turn-check disabled")
                    u = int(inv[b])
                    out.append(
                        self._finish(
                            q, ranked_np=(vals[u], ids[u]),
                            allow_refetch=False,
                        )
                    )
                self._finish_escalated(queries, out)
            return out
        inv = None
        if cfg.turn == TURN_NONE:
            for q in queries:
                q.set_attr("turn_slv", "turn-check disabled")
            variants_per = 1
            mask_list, inv = self._dedupe_masks(
                [q.masks for q in queries]
            )
        else:
            all4 = cfg.turn == TURN_ALL
            variants_per = 4 if all4 else 2
            mask_list = []
            for q in queries:
                mask_list.append(q.masks)
                if all4:
                    mask_list.append(q.copy().reverse().masks)
                    mask_list.append(q.copy().complement().masks)
                mask_list.append(
                    q.copy().reverse().complement().masks
                )
        k0 = min(
            max(4 * cfg.fs_max + 16, 256), self.index.n_seqs
        )
        vals, ids = self.score_topk(mask_list, k0)

        out: list[FamilyResult | None] = [None] * B
        reoriented: list[tuple[int, Sequence]] = []
        for b, q in enumerate(queries):
            row = int(inv[b]) if inv is not None else b * variants_per
            if cfg.turn != TURN_NONE:
                tops = vals[row : row + variants_per, 0]
                order = (
                    [0, 1, 2, 3]
                    if variants_per == 4
                    else [0, 3]
                )
                best, best_score = 0, 0.0
                for kk, oi in enumerate(order):
                    if tops[kk] > best_score:
                        best_score = float(tops[kk])
                        best = oi
                names = [
                    "none", "reversed", "complemented",
                    "reversed and complemented",
                ]
                q.set_attr("turn_slv", names[best])
                if best in (1, 3):
                    q.reverse()
                if best in (2, 3):
                    q.complement()
                if best != 0:
                    # orientation changed: rescore, batched with the
                    # other reoriented queries below (one device call
                    # total even for revcomp-heavy batches)
                    reoriented.append((b, q))
                    continue
            out[b] = self._finish(
                q, ranked_np=(vals[row], ids[row]),
                allow_refetch=False,
            )
        if reoriented:
            v1, i1 = self.score_topk(
                [q.masks for _, q in reoriented], k0
            )
            for row, (b, q) in enumerate(reoriented):
                out[b] = self._finish(
                    q, ranked_np=(v1[row], i1[row]),
                    allow_refetch=False,
                )
        self._finish_escalated(queries, out)
        return out

    def _finish_escalated(self, queries, out) -> None:
        """Batched constraint-escalation refetch
        (famfinder.cpp:591-608's x10 retry): queries whose candidate
        list ran out are re-scored together at an escalating device
        top-k (x10 per rung) so only O(B*k) candidates cross the
        host link instead of full (B, n_seqs) score rows."""
        todo = [b for b, r in enumerate(out) if r is None]
        if not todo:
            return
        n = self.index.n_seqs
        k = min(
            max(4 * self.cfg.fs_max + 16, 256) * 10, n
        )
        while todo:
            uniq, einv = self._dedupe_masks(
                [queries[b].masks for b in todo]
            )
            vals, ids = self.score_topk(uniq, k)
            still: list[int] = []
            for row, b in enumerate(todo):
                u = int(einv[row])
                res = self._finish(
                    queries[b], ranked_np=(vals[u], ids[u]),
                    allow_refetch=(k >= n),
                )
                if res is None:
                    still.append(b)
                else:
                    out[b] = res
            todo = still
            if k >= n:
                break
            k = min(k * 10, n)

    def __call__(self, query: Sequence) -> FamilyResult:
        self.apply_turn(query)
        return self._finish(query)

    def _finish(
        self,
        query: Sequence,
        scores: np.ndarray | None = None,
        ranked: list[tuple[float, int]] | None = None,
        allow_refetch: bool = True,
        ranked_np: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> FamilyResult | None:
        """Post-turn-check famfinder stage body
        (famfinder.cpp:439-494).  Returns None when the candidate
        list ran out and allow_refetch is False (escalation deferred
        to the batched caller).  `ranked_np` passes the device top-k
        row pair (vals, ids) directly so the common config runs the
        vectorized filter without building candidate tuple lists."""
        cfg = self.cfg
        if ranked_np is not None and self._fast_policy_ok():
            family = self._match_fast(ranked_np[0], ranked_np[1])
            if family is None:
                if not allow_refetch:
                    return None
                family = self.match(
                    query,
                    ranked=[
                        (float(v), int(i))
                        for v, i in zip(*ranked_np)
                        if v >= 0
                    ],
                    allow_refetch=True,
                )
        else:
            if ranked_np is not None:
                ranked = [
                    (float(v), int(i))
                    for v, i in zip(*ranked_np)
                    if v >= 0
                ]
            family = self.match(
                query, scores=scores, ranked=ranked,
                allow_refetch=allow_refetch,
            )
        if family is None:
            return None

        # family string attr (famfinder.cpp:458-470)
        fam_str = " ".join(
            f"{s.get_attr('acc', s.name)}.{s.get_attr('start', '0')}"
            f":{score:.2f}"
            for score, s in family
        )
        query.set_attr("align_family_slv", fam_str)

        if cfg.fs_req_gaps:
            family = [
                (sc, s)
                for sc, s in family
                if len(s) and s.internal_gaps() >= cfg.fs_req_gaps
            ]
        name, weights, log = self.select_astats(family)
        res = FamilyResult(family, name, weights, log)
        if len(family) < cfg.fs_req:
            res.log.append(
                f"unable to align: too few relatives ({len(family)});"
            )
            res.failed = True
        return res
