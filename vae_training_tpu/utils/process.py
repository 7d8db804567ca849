"""Multi-process (multi-host) role helpers.

In a ``jax.distributed`` run every process executes the same program — all
processes must participate in every collective device computation — but
host-side effects (artifact files, checkpoints, console stats) must happen
exactly once. The reference is single-process (its only distributed gesture
is the dead pmean hook at reference/utils.py:215-221); here process 0
is the writer, the idiomatic JAX multi-host convention.
"""

from __future__ import annotations

import jax


def is_primary() -> bool:
    """True iff this is the artifact-writing process (process_index 0;
    trivially True in single-process runs)."""
    return jax.process_index() == 0


def check_shared_fs(exists, path: str, what: str = "checkpoint") -> None:
    """Make the multi-process restore path's shared-filesystem assumption
    EXPLICIT. Every process restores a checkpoint itself (device state must
    be rebuilt on every host), which silently requires ``path`` on a
    filesystem visible to all of them — on a pod with per-host disks,
    process>0 would crash on the read, or worse, a missing file on a
    non-primary could silently fork the run. Allgather the local visibility
    and fail with the requirement spelled out when processes disagree.
    No-op single-process.

    ``exists`` is one bool (solo runs: the checkpoint dir) or a sequence of
    bools (grid runs: one PER ROW dir). The per-row form matters: with
    per-host disks each process sees exactly its own rows' checkpoints, so
    a single ``all(...)`` aggregate would be False on EVERY process — the
    guard would pass and the restore would die later on a raw
    FileNotFoundError for the first non-owned row."""
    if jax.process_count() == 1:
        return
    import numpy as np
    from jax.experimental import multihost_utils

    local = np.atleast_1d(np.asarray(exists, np.int32))
    flags = np.asarray(multihost_utils.process_allgather(local))
    flags = flags.reshape(jax.process_count(), -1)  # (process, entry)
    disagree = [int(j) for j in
                np.nonzero((flags != flags[0:1]).any(axis=0))[0]]
    if disagree:
        def procs(mask):
            return [int(p) for p in np.nonzero(mask)[0]]

        detail = "; ".join(
            (f"entry {j}: " if flags.shape[1] > 1 else "")
            + f"visible to process(es) {procs(flags[:, j])} but NOT to "
              f"{procs(1 - flags[:, j])}"
            for j in disagree[:8])
        raise ValueError(
            f"multihost restore: the {what} at {path!r} is not uniformly "
            f"visible across processes ({detail}). Multi-process "
            f"--resume/--state_dict requires the run directory on a SHARED "
            f"filesystem mounted on every host — each process restores the "
            f"checkpoint itself; divergent visibility would crash the "
            f"missing process or silently fork the run."
        )
