"""Multi-host scale-out helpers.

The reference scales to multiple machines by running N independent
processes over byte-range shards of one FASTA (--fasta-block /
--fasta-idx, rw_fasta.cpp:209-242) plus the historical psina wrapper.
sina-tpu keeps that input-sharding path (io/fasta.py) and adds the
jax-native route: `jax.distributed.initialize` + a global mesh whose
"mp" (index shard) axis stays within a host and "dp" (query batches)
spans hosts, with each host reading its own --fasta-block.

Tested with two CPU processes (tests/test_multihost.py); the entry
point is kept minimal and documented.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("sina.multihost")


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialise jax.distributed for a multi-host run.

    Where JAX's cluster detection applies (e.g. SLURM) every argument
    is autodetected; pass them explicitly otherwise.  Call before any jax usage, then
    build the pipeline as usual: `parallel.sharding.make_mesh` sees
    all global devices.
    """
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    logger.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def host_input_shard(path, n_bytes: int | None = None):
    """Per-host --fasta-block parameters: split the input file evenly
    over jax.process_count() hosts (reference: manual --fasta-block /
    --fasta-idx per process)."""
    import os

    import jax

    n = jax.process_count()
    idx = jax.process_index()
    size = n_bytes if n_bytes is not None else os.path.getsize(path)
    block = size // n + 1
    return {"fasta_block": block, "fasta_idx": idx}
