"""Multi-host (DCN) scaffolding for the scan pipeline.

The reference scales across hosts with Nextflow/SGE: each node runs the
jar over a subset of fastq files and `MergeReadScannerStats` merges the
serialized stats (SURVEY §2.d "Nextflow DAG / multi-host scale-out").

The equivalent here is a jax.distributed job: every process owns
the fastq files `files[process_index::process_count]`, scans them on its
local devices, and the tiny cross-host state (pass-1 whitelist hit counts —
one int64 per whitelist entry) is summed over DCN with a psum on the
global mesh. Pass 2 then runs per-host against the identical merged used
list, so per-host outputs concatenate into exactly the single-host result
(asserted by tests/test_multihost.py with a 2-process CPU cluster).
"""
from __future__ import annotations

import numpy as np


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None):
    """jax.distributed entry point (idempotent).

    jax.distributed.initialize detects them only under a cluster manager
    it knows (SLURM, Open MPI, Kubernetes); a plain GPU host or CPU test
    cluster must pass all three explicitly (coordinator "host:port",
    num_processes, process_id)."""
    import jax

    if jax.process_count() > 1:  # already initialized
        return
    kw = {}
    if coordinator is not None:
        kw = dict(coordinator_address=coordinator,
                  num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kw)


def shard_files(files: list, process_index: int | None = None,
                process_count: int | None = None) -> list:
    """The host's file shard: files[pid::nproc] (sorted for determinism)."""
    import jax

    pid = jax.process_index() if process_index is None else process_index
    n = jax.process_count() if process_count is None else process_count
    return sorted(files)[pid::n]


def allreduce_counts(counts: np.ndarray) -> np.ndarray:
    """Sum an int64 host vector across all processes (DCN psum).

    Single-process: identity. Multi-process: every process contributes its
    local pass-1 whitelist counts; all receive the global sums, so each
    host derives the identical used-barcode list."""
    import jax

    if jax.process_count() == 1:
        return counts
    from jax.experimental import multihost_utils

    stacked = multihost_utils.process_allgather(
        counts.astype(np.int64), tiled=False)  # [nproc, N]
    return np.asarray(stacked).sum(axis=0)


def merge_scalar_stats(values: dict) -> dict:
    """Sum a {name: int} stats dict across processes (the statmerger role
    for live multi-host runs; file-based merging stays in
    pipeline/mergestats.py for offline/demon runs)."""
    import jax

    if jax.process_count() == 1:
        return dict(values)
    from jax.experimental import multihost_utils

    keys = sorted(values)
    vec = np.array([int(values[k]) for k in keys], np.int64)
    stacked = multihost_utils.process_allgather(vec, tiled=False)
    tot = np.asarray(stacked).sum(axis=0)
    return {k: int(v) for k, v in zip(keys, tot)}
