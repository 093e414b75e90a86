"""The profile chain DP: the CUDA kernel's wrapper and contract, and
the plain XLA recurrences it is checked against.

The kernel itself only runs on an NVIDIA GPU (tests marked `gpu`).
Everywhere else the wrapper runs with chain_dp_reference, which has
the kernel's contract, so its shapes, padding, layout decode and the
traceback are covered on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sina_tpu.ops import align_kernel as ak
from sina_tpu.ops import chain_dp_cuda as cc
from sina_tpu.ops import profile as prof
from sina_tpu.ops.align_kernel import DpParams


def _inputs(B, C, M, seed):
    rng = np.random.default_rng(seed)
    freqs = rng.random((B, C, 4)).astype(np.float32)
    freqs /= freqs.sum(axis=2, keepdims=True) * 1.25
    gapcost = (rng.random((B, C)) * 2).astype(np.float32)
    qmask = (1 << rng.integers(0, 4, (B, M))).astype(np.uint8)
    qlen = rng.integers(max(1, M // 2), M + 1, B).astype(np.int32)
    cr = rng.integers(max(1, C // 2), C + 1, B).astype(np.int32)
    for b in range(B):
        qmask[b, qlen[b]:] = 0
    return freqs, gapcost, qmask, qlen, cr


@pytest.mark.parametrize(
    "m_len, per_thread, m_pad",
    [(1, 1, 32), (48, 1, 64), (256, 1, 256), (1536, 4, 1536),
     (2048, 4, 2048), (3000, 8, 3072), (16384, 16, 16384)],
)
def test_layout(m_len, per_thread, m_pad):
    e, mp = cc.layout(m_len)
    assert (e, mp) == (per_thread, m_pad)
    assert mp >= m_len and mp % (32 * e) == 0
    assert mp // e <= 1024


def test_layout_rejects_too_long():
    with pytest.raises(ValueError, match="limit"):
        cc.layout(16385)


@pytest.mark.parametrize(
    "B, C, M, dedup",
    [(3, 48, 64, False), (5, 37, 50, False), (16, 40, 56, True),
     (4, 96, 200, False)],
)
def test_kernel_path_matches_xla_path(B, C, M, dedup):
    """The kernel path (M padded to the kernel layout, compact
    backpointers, lax chain traceback, int16 log decoded on the host)
    reproduces the XLA path's emissions, ends and scores."""
    params = DpParams()
    freqs, gapcost, qmask, qlen, cr = _inputs(B, C, M, seed=B + C)
    fg = prof._pack_fgq(freqs, gapcost, params)
    lens = np.stack([qlen, cr], axis=1).astype(np.int32)
    args = [jnp.asarray(x) for x in (fg, qmask, lens)]
    if dedup:
        fam_idx = jnp.asarray(np.arange(B, dtype=np.int32) % 3)
        args.append(fam_idx)
    xla = prof._profile_batched_fn(C, M, params, dedup=dedup)
    ker = prof._profile_kernel_fn(
        C, M, params, dedup=dedup, chain=cc.chain_dp_reference
    )
    want = prof._unpack_result(np.asarray(xla(*args)))
    packed = np.asarray(ker(*args))
    assert packed.dtype == np.int16  # compact log + aux words
    got = prof._unpack_log_result(packed, M)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("aspace", [False, True])
def test_dispatch_picks_kernel_on_gpu(monkeypatch, aspace):
    """On the GPU, profile_dp_dispatch runs the kernel path, except
    with an insertion budget (--insertion=forbid), which stays on the
    XLA path; both give the XLA path's answer."""
    from sina_tpu import backend

    params = DpParams()
    B, C, M = 16, 40, 48
    freqs, gapcost, qmask, qlen, cr = _inputs(B, C, M, seed=3)
    budget = (
        np.random.default_rng(4).integers(0, 4, (B, C)).astype(np.int32)
        if aspace else None
    )
    want = prof.profile_dp_fetch(prof.profile_dp_dispatch(
        freqs, gapcost, qmask, qlen, cr, params, budget=budget
    ))
    monkeypatch.setattr(backend, "dp_backend", lambda: "cuda")
    monkeypatch.setattr(cc, "chain_dp_cuda", cc.chain_dp_reference)
    prof._profile_kernel_fn.cache_clear()
    prof._profile_wire_fn.cache_clear()
    try:
        handle = prof.profile_dp_dispatch(
            freqs, gapcost, qmask, qlen, cr, params, budget=budget
        )
        assert handle[0] == ("xla" if aspace else "log")
        got = prof.profile_dp_fetch(handle)
    finally:
        prof._profile_kernel_fn.cache_clear()
        prof._profile_wire_fn.cache_clear()
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def _chain_graph(C, cr):
    preds = (np.arange(C, dtype=np.int32) - 1).reshape(C, 1)
    is_start = np.arange(C) == 0
    is_end = np.arange(C) == cr - 1
    return jnp.asarray(preds), jnp.asarray(is_start), jnp.asarray(is_end)


@pytest.mark.parametrize(
    "C, M, budget_max",
    [(12, 10, None), (30, 41, None), (64, 17, None), (7, 33, None),
     (25, 30, 3), (40, 24, 1)],
)
def test_chain_dp_matches_graph_core(C, M, budget_max):
    """chain_dp (the kernel's reference recurrences) equals the
    general graph core poa_dp_costs on a chain-shaped graph: same
    move codes, deletion-open bits, ends and score."""
    rng = np.random.default_rng(C * M)
    cr = int(rng.integers(C // 2, C + 1))
    qlen = int(rng.integers(M // 2, M + 1))
    sub = jnp.asarray(rng.uniform(-2, 1, (C, M)).astype(np.float32))
    occ = jnp.asarray(rng.uniform(0.3, 1.0, C).astype(np.float32))
    go, ge = jnp.float32(5.0), jnp.float32(2.0)
    budget = (
        None if budget_max is None
        else jnp.asarray(
            rng.integers(0, budget_max + 1, C).astype(np.int32)
        )
    )
    sub = jnp.where(jnp.arange(C)[:, None] >= cr, ak.BIG, sub)
    bp1, c1, i1, r1 = prof.chain_dp(
        sub, go * occ, ge * occ, go, ge, jnp.int32(qlen),
        jnp.int32(cr), C, M, ins_budget=budget,
    )
    preds, is_start, is_end = _chain_graph(C, cr)
    bp2, c2, i2, r2 = ak.poa_dp_costs(
        sub, go * occ, ge * occ, jnp.full(C, go), jnp.full(C, ge),
        preds, is_start, is_end, jnp.int32(qlen), jnp.int32(cr),
        n_nodes=C, m_len=M, ins_budget=budget,
    )
    assert (int(c1), int(i1)) == (int(c2), int(i2))
    assert float(r1) == float(r2)
    rows = np.arange(C) < cr
    keep = 0x3 | (1 << 8)  # move code + deletion opened
    np.testing.assert_array_equal(
        np.asarray(bp1)[rows] & keep, np.asarray(bp2)[rows] & keep
    )


@pytest.mark.parametrize("forbid", [False, True])
def test_windowed_graph_core_has_no_matmul(forbid):
    """The windowed graph core gathers predecessor rows exactly: a
    float32 dot_general may run in TF32 on a GPU and round DP
    values, so none may appear in its program."""
    N, M, P = 16, 12, 3
    args = (
        jnp.zeros((N, M), jnp.float32),
        jnp.ones(N, jnp.float32), jnp.ones(N, jnp.float32),
        jnp.ones(N, jnp.float32), jnp.ones(N, jnp.float32),
        jnp.full((N, P), -1, jnp.int32),
        jnp.zeros(N, bool), jnp.zeros(N, bool),
        jnp.int32(M), jnp.int32(N),
    )
    kw = dict(n_nodes=N, m_len=M, window=8)
    if forbid:
        kw["ins_budget"] = jnp.zeros(N, jnp.int32)
    text = str(jax.make_jaxpr(
        lambda *a: ak.poa_dp_costs_windowed(*a, **kw)
    )(*args))
    assert "dot_general" not in text


@pytest.mark.gpu
def test_kernel_matches_reference_on_gpu(gpu):
    """On the card: the CUDA kernel's forward pass equals the XLA
    reference — ends, scores and every backpointer row the traceback
    can read."""
    params = DpParams()
    B, C, M = 8, 300, 700
    freqs, gapcost, qmask, qlen, cr = _inputs(B, C, M, seed=9)
    e, m_pad = cc.layout(M)
    qm = np.pad(qmask, ((0, 0), (0, m_pad - M)))
    lens = np.stack([qlen, cr], 1).astype(np.int32)
    args = [jax.device_put(x, gpu) for x in (freqs, gapcost, qm, lens)]
    got = [np.asarray(x) for x in jax.jit(
        lambda *a: cc.chain_dp_cuda(*a, params, e)
    )(*args)]
    want = [np.asarray(x) for x in jax.jit(
        lambda *a: cc.chain_dp_reference(*a, params, e)
    )(*args)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)
    rows = np.arange(C)[None, :] < cr[:, None]
    np.testing.assert_array_equal(got[0][rows], want[0][rows])
