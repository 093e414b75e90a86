"""POA reference graph, linearised for the batched graph DP.

Semantics follow mseq (/root/reference/src/mseq.cpp:46-118, mseq.h):
one node per (alignment column, base) pair present in the family; node
weight blends a floor with the base's frequency at that column,
``1/(fw+1) + fw * count/num_seqs`` (mseq.cpp:111-116); edges follow
each sequence's base succession; duplicate edges removed.

Instead of an intrusive linked DAG we emit flat arrays in topological
order (columns ascend along every edge): positions, masks, weights,
padded predecessor lists, start/end flags, and the per-node insertion
budget ("free columns before the next node", mesh.h:480-484) used by
--insertion=forbid.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sequence import Sequence

MAX_PREDS = 8


@dataclass
class LinearGraph:
    pos: np.ndarray        # (N,) int32 alignment column per node
    mask: np.ndarray       # (N,) uint8 IUPAC bitmask per node
    weight: np.ndarray     # (N,) float32 node weight
    preds: np.ndarray      # (N, P) int32 predecessor node ids, -1 pad
    is_start: np.ndarray   # (N,) bool  nodes with no predecessors
    is_end: np.ndarray     # (N,) bool  nodes with no successors
    max_insert: np.ndarray  # (N,) int32 insertion budget after node
    width: int             # alignment width

    @property
    def n_nodes(self) -> int:
        return len(self.pos)


def build_graph(
    family: list[Sequence], fs_weight: float = 1.0
) -> LinearGraph:
    if not family:
        raise ValueError("empty family")
    width = family[0].width
    for s in family:
        if s.width != width:
            raise ValueError(
                f"family sequence {s.name} width {s.width} != {width}"
            )
    num_seqs = len(family)

    # node key: (column, mask-char) -> node id; nodes created in column
    # order so ids are already topological (columns ascend along edges).
    # The lowercase bit is stripped: case variants merge into one node
    # (the DP's compatibility test is case-free anyway)
    all_pos = np.concatenate([s.positions for s in family])
    all_mask = np.concatenate([s.masks for s in family]) & 0xF
    # np.unique over packed key gives nodes sorted by (pos, mask)
    key = all_pos.astype(np.int64) << 8 | all_mask.astype(np.int64)
    uniq, inverse, counts = np.unique(
        key, return_inverse=True, return_counts=True
    )
    n = len(uniq)
    pos = (uniq >> 8).astype(np.int32)
    mask = (uniq & 0xFF).astype(np.uint8)
    weight = (
        1.0 / (fs_weight + 1.0)
        + fs_weight * counts.astype(np.float32) / num_seqs
    ).astype(np.float32)

    # edges: consecutive bases within each sequence
    edge_src = []
    edge_dst = []
    off = 0
    for s in family:
        m = len(s.positions)
        ids = inverse[off : off + m]
        if m > 1:
            edge_src.append(ids[:-1])
            edge_dst.append(ids[1:])
        off += m
    if edge_src:
        src = np.concatenate(edge_src)
        dst = np.concatenate(edge_dst)
        ekey = src.astype(np.int64) * n + dst
        ekey = np.unique(ekey)
        src = (ekey // n).astype(np.int32)
        dst = (ekey % n).astype(np.int32)
    else:
        src = np.zeros(0, np.int32)
        dst = np.zeros(0, np.int32)

    preds = np.full((n, MAX_PREDS), -1, dtype=np.int32)
    has_succ = np.zeros(n, dtype=bool)
    # edges sorted by dst (stable keeps src ascending within dst, so
    # pred slots are id-ascending); slot = rank within the dst group,
    # ranks >= MAX_PREDS truncated (rare; documented deviation)
    order = np.argsort(dst, kind="stable")
    d_sorted = dst[order]
    s_sorted = src[order]
    first = np.searchsorted(d_sorted, d_sorted, side="left")
    ranks = np.arange(len(d_sorted)) - first
    keep = ranks < MAX_PREDS
    preds[d_sorted[keep], ranks[keep]] = s_sorted[keep]
    pred_count = np.bincount(dst, minlength=n).astype(np.int32)
    has_succ[src] = True

    is_start = pred_count == 0
    is_end = ~has_succ

    # insertion budget: min successor position - pos - 1 (mesh.h:480-484)
    min_next = np.full(n, np.iinfo(np.int32).max, dtype=np.int64)
    if len(src):
        np.minimum.at(min_next, src, pos[dst].astype(np.int64))
    max_insert = np.where(
        has_succ, min_next - pos - 1, np.int64(10**6)
    ).astype(np.int32)

    return LinearGraph(
        pos, mask, weight, preds, is_start, is_end, max_insert, width
    )


# Reusable capacity-sized output buffers for the native batch graph
# builder.  A fresh np.empty per call page-faulted ~230MB each batch
# (15-20s on this slow-memory host — 30x the actual build, the reason
# the native path was once demoted); reusing the arena pays the fault
# cost once per process.  The per-family LinearGraphs COPY their
# compact slices out (a few MB), so the arena is free to be
# overwritten by the next batch while earlier graphs are still alive
# in the software pipeline.  Host orchestration is single-threaded.
_graph_arena: dict[str, np.ndarray] = {}


def _arena(name: str, n: int, dtype) -> np.ndarray:
    buf = _graph_arena.get(name)
    if buf is None or buf.size < n:
        cap = n if buf is None else max(n, buf.size * 2)
        buf = np.empty(cap, dtype)
        _graph_arena[name] = buf
    return buf[:n]


def build_graphs_batch(
    families: list[list[Sequence]], fs_weight: float = 1.0
) -> list[LinearGraph]:
    """Batched build_graph over many families: one parallel native
    pass (sina_build_graphs, parity-tested vs build_graph) writing
    into a reused arena.  SINA_TPU_NATIVE_GRAPHS=0 forces the
    per-family numpy path."""
    import os

    if os.environ.get("SINA_TPU_NATIVE_GRAPHS", "1") == "0":
        return [build_graph(f, fs_weight) for f in families]
    from .. import native

    seqs = [s for f in families for s in f]
    refs = [getattr(s, "_flat_ref", None) for s in seqs]
    r0 = refs[0] if refs else None
    ok = r0 is not None and all(
        r is not None and r[0] is r0[0] and r[4] is s.positions
        for r, s in zip(refs, seqs)
    )
    if not ok:
        return [build_graph(f, fs_weight) for f in families]
    n_fams = len(families)
    starts = np.fromiter((r[2] for r in refs), np.int64, len(refs))
    lens = np.fromiter(
        (r[3] - r[2] for r in refs), np.int64, len(refs)
    )
    fam_sizes = np.array([len(f) for f in families], np.int64)
    # per-family node capacity = its total bases
    caps = np.zeros(n_fams, np.int64)
    k = 0
    for f, sz in enumerate(fam_sizes):
        caps[f] = lens[k : k + sz].sum()
        k += sz
    node_offsets = np.zeros(n_fams + 1, np.int64)
    np.cumsum(caps, out=node_offsets[1:])
    total = int(node_offsets[-1])
    lib = native.get_lib()
    if lib is None or total == 0:
        return [build_graph(f, fs_weight) for f in families]
    out_pos = _arena("pos", total, np.int32)
    out_mask = _arena("mask", total, np.uint8)
    out_count = _arena("count", total, np.int32)
    out_preds = _arena("preds", total * MAX_PREDS, np.int32).reshape(
        total, MAX_PREDS
    )
    out_flags = _arena("flags", total, np.uint8)
    out_maxins = _arena("maxins", total, np.int32)
    n_nodes = np.zeros(n_fams, np.int64)

    rc = lib.sina_build_graphs(
        np.ascontiguousarray(r0[0], np.uint32),
        np.ascontiguousarray(r0[1], np.uint8),
        starts, lens, fam_sizes, n_fams,
        node_offsets, MAX_PREDS,
        out_pos, out_mask, out_count, out_preds, out_flags,
        out_maxins, n_nodes, native._n_threads(),
    )
    if rc != 0:
        return [build_graph(f, fs_weight) for f in families]
    out = []
    for f in range(n_fams):
        lo = int(node_offsets[f])
        n = int(n_nodes[f])
        counts = out_count[lo : lo + n].astype(np.float32)
        weight = (
            1.0 / (fs_weight + 1.0)
            + fs_weight * counts / len(families[f])
        ).astype(np.float32)
        flags = out_flags[lo : lo + n]
        # copies, not views: the arena is reused by the next batch
        out.append(
            LinearGraph(
                out_pos[lo : lo + n].copy(),
                out_mask[lo : lo + n].copy(),
                weight,
                out_preds[lo : lo + n].copy(),
                (flags & 1) != 0,
                (flags & 2) != 0,
                out_maxins[lo : lo + n].copy(),
                families[f][0].width,
            )
        )
    return out


def graph_to_dot(g: LinearGraph, name: str = "reference") -> str:
    """Graphviz dump of the POA graph (--debug-graph; semantics of
    dag::print_graphviz, /root/reference/src/graph.h:359-394)."""
    from .. import alphabet

    lines = [f"digraph {name} {{", "rotate=90"]
    for j in range(g.n_nodes):
        ch = chr(alphabet.MASK_TO_RNA[g.mask[j]])
        lines.append(
            f'n{j} [ label = "{ch}({g.pos[j]})" ];'
        )
        for p in g.preds[j]:
            if p >= 0:
                lines.append(f"n{p} -> n{j};")
    lines.append("}")
    return "\n".join(lines) + "\n"


def pad_graph(g: LinearGraph, n_pad: int) -> LinearGraph:
    """Pad node arrays to n_pad for shape-bucketed batching.  Padding
    nodes are isolated non-start non-end nodes at the final column."""
    n = g.n_nodes
    if n_pad < n:
        raise ValueError(f"pad {n_pad} < nodes {n}")
    e = n_pad - n
    return LinearGraph(
        np.concatenate([g.pos, np.full(e, g.width - 1, np.int32)]),
        np.concatenate([g.mask, np.zeros(e, np.uint8)]),
        np.concatenate([g.weight, np.zeros(e, np.float32)]),
        np.concatenate(
            [g.preds, np.full((e, g.preds.shape[1]), -1, np.int32)]
        ),
        np.concatenate([g.is_start, np.zeros(e, bool)]),
        np.concatenate([g.is_end, np.zeros(e, bool)]),
        np.concatenate([g.max_insert, np.zeros(e, np.int32)]),
        g.width,
    )
