"""The CUDA profile chain DP (ops/cuda/chain_dp.cu) as a JAX operation.

The kernel is compiled with nvcc for sm_90a from the repository's
source into ``ops/cuda/build/`` (git-ignored) on first use, loaded with
ctypes and registered as an XLA FFI target for the CUDA platform.
``chain_dp_reference`` has the kernel's contract and computes it with
the plain XLA chain DP (ops/profile.chain_dp); tests use it where there
is no GPU.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "cuda" / "chain_dp.cu"
_SO = Path(__file__).parent / "cuda" / "build" / "libsina_chain_dp.so"
TARGET = "sina_chain_dp"

# threads per block the layout aims for; E lanes per thread grows in
# powers of two (up to 16) until the block fits
_TARGET_THREADS = 512


def layout(m_len: int) -> tuple[int, int]:
    """(lanes per thread E, padded query length) for a query bucket of
    m_len bases.  The padded length is a multiple of 32*E with at most
    1024 threads per block; padding lanes sit right of every real lane,
    and the DP only carries information rightwards, so they never
    change a real lane."""
    e = 1
    while e < 16 and -(-m_len // e) > _TARGET_THREADS:
        e *= 2
    threads = -(-m_len // (32 * e)) * 32
    if threads > 1024:
        raise ValueError(
            f"query bucket of {m_len} bases exceeds the chain DP "
            f"kernel's limit of {1024 * 16}"
        )
    return e, threads * e


def _build() -> None:
    import jax

    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return
    _SO.parent.mkdir(exist_ok=True)
    nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = [
        str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(), "-o", str(tmp), str(_SRC),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {_SRC.name}:\n{res.stderr}"
        )
    os.replace(tmp, _SO)


@functools.cache
def _register() -> ctypes.CDLL:
    """Build (if stale) and register the FFI target once per process;
    the returned library stays referenced by the cache."""
    import jax

    _build()
    lib = ctypes.CDLL(str(_SO))
    jax.ffi.register_ffi_target(
        TARGET, jax.ffi.pycapsule(lib.SinaChainDp), platform="CUDA"
    )
    return lib


def _out_types(freqs, qmask):
    import jax
    import jax.numpy as jnp

    B, C = freqs.shape[:2]
    return (
        jax.ShapeDtypeStruct((B, C, qmask.shape[1]), jnp.uint8),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.float32),
    )


def chain_dp_cuda(freqs, gapcost, qmask, lens, params, per_thread: int):
    """Run the kernel.  freqs (B, C, 4) f32, gapcost (B, C) f32, qmask
    (B, Mp) uint8 with Mp from layout(), lens (B, 2) int32 = (query
    length, real column count).  Returns (bp (B, C, Mp) uint8 in the
    compact chain layout, best_c (B,) int32, best_i (B,) int32, raw
    (B,) f32).  Backpointer rows at or past a query's real column
    count are left unwritten."""
    import jax

    _register()
    f32 = np.float32
    return jax.ffi.ffi_call(TARGET, _out_types(freqs, qmask))(
        freqs, gapcost, qmask, lens,
        go=f32(params.gap_open), ge=f32(params.gap_ext),
        m_mm=f32(params.match) - f32(params.mismatch),
        mm=f32(params.mismatch), per_thread=np.int32(per_thread),
    )


def chain_dp_reference(freqs, gapcost, qmask, lens, params,
                       per_thread: int):
    """chain_dp_cuda's contract computed by the plain XLA chain DP:
    the same substitution costs (profile.sub_costs) and recurrences
    (profile.chain_dp), with the uint16 backpointers repacked into the
    compact uint8 chain layout."""
    import jax
    import jax.numpy as jnp

    from .profile import chain_dp, sub_costs

    del per_thread  # a launch detail of the kernel
    C, M = freqs.shape[1], qmask.shape[1]
    go = jnp.float32(params.gap_open)
    ge = jnp.float32(params.gap_ext)

    def one(fq, gc, qm, ln):
        sub, occ = sub_costs(fq, gc, qm, ln[1], params)
        bp, bc, bi, raw = chain_dp(
            sub, go * occ, ge * occ, go, ge, ln[0], ln[1], C, M
        )
        compact = (
            (bp & 0x3)
            | (((bp >> 8) & 1) << 2)
            | (((bp >> 9) & 1) << 3)
        ).astype(jnp.uint8)
        return compact, bc.astype(jnp.int32), bi.astype(jnp.int32), raw

    return jax.vmap(one)(freqs, gapcost, qmask, lens)
