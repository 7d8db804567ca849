"""Full training checkpoints with a WORKING resume path.

The reference half-implements this: it saves an optimizer state dict at every
plot interval but never calls its own load path (reference/model.py:37-43,
91-94; SURVEY.md §3.5). Here a checkpoint is the complete ``TrainState`` —
params, Adam moments, step counter, and both PRNG base keys — written as
one ``.npz`` of its leaves keyed by tree path (numpy only), so
``--resume <dir>`` continues bit-exactly where the run stopped (same
fold_in(step) key derivation ⇒ the resumed run consumes the identical
random stream).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

CKPT_NAME = "ckpt.npz"
META_NAME = "ckpt_meta.json"
AUX_NAME = "ckpt_aux.pkl"
# One level of checkpoint retention: each npz save sets the previous
# {ckpt, aux, meta} trio aside under this suffix instead of overwriting it.
# Grid fault tolerance depends on it — a SIGKILL can land between two rows'
# (or two processes') checkpoint flushes, leaving rows one save event apart;
# the .prev trio of the row that got ahead is exactly at the grid's common
# step, so GridTrainer.restore can roll it back (train/grid.py:restore).
PREV_SUFFIX = ".prev"

_async_executor = None
# One writer at a time per process: the plot-cadence sync save and the
# --checkpoint_every async save target the same files.
_write_lock = threading.Lock()
# First exception from a background save — surfaced on the NEXT async save
# (or wait_for_pending_saves) so a full disk can't silently disable
# checkpointing for hours while training continues.
_async_error: Optional[BaseException] = None


def _tmp_suffix() -> str:
    return f".tmp.{os.getpid()}.{threading.get_ident()}"


def _executor():
    global _async_executor
    if _async_executor is None:
        from concurrent.futures import ThreadPoolExecutor

        _async_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer"
        )
    return _async_executor


def _read_meta(dirname: str, prev: bool = False) -> Optional[dict]:
    name = META_NAME + (PREV_SUFFIX if prev else "")
    try:
        with open(os.path.join(dirname, name)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def read_checkpoint_meta(dirname: str, prev: bool = False) -> Optional[dict]:
    """The checkpoint's metadata dict (step, backend, extras), or None.
    ``prev=True`` reads the retained previous save's metadata."""
    return _read_meta(dirname, prev=prev)


def _write_aux(dirname: str, aux, suffix: str) -> None:
    """Pickle the host-side run state (StatsRecorder history, eval-key
    counter, host key chain) next to the device checkpoint, atomically.
    This is what makes a preempted+resumed run's artifacts identical to an
    uninterrupted run's — the TrainState alone only makes the TRAINING
    stream bit-exact (ref artifact contract: reference/model.py:246-252)."""
    import pickle

    aux_path = os.path.join(dirname, AUX_NAME)
    tmp = aux_path + suffix
    with open(tmp, "wb") as f:
        pickle.dump(aux, f)
    os.replace(tmp, aux_path)


def restore_checkpoint_aux(dirname: str, prev: bool = False) -> Optional[dict]:
    """Host-side run state saved alongside the checkpoint (None for
    checkpoints written before aux existed). ``prev=True`` reads the
    retained previous save's aux (grid rollback)."""
    import pickle

    name = AUX_NAME + (PREV_SUFFIX if prev else "")
    try:
        with open(os.path.join(dirname, name), "rb") as f:
            return pickle.load(f)
    except OSError:
        return None


def _write_npz(path: str, state) -> None:
    """Every leaf of ``state`` as one array, keyed by its tree path.
    numpy has no bfloat16, so bf16 leaves (--adam_dtype bf16 moments) are
    stored as their uint16 bit patterns."""
    arrays = {}
    for key_path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(state)):
        a = np.asarray(leaf)
        if a.dtype == jnp.bfloat16:
            a = a.view(np.uint16)
        arrays[jax.tree_util.keystr(key_path)] = a
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _read_npz(path: str, template):
    """Rebuild ``template``'s tree from an npz written by _write_npz."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    with np.load(path) as z:
        for key_path, t in flat:
            key = jax.tree_util.keystr(key_path)
            if key not in z.files:
                raise ValueError(
                    f"checkpoint {path} has no leaf {key}: it was written "
                    f"for another model or optimizer configuration")
            a = z[key]
            dtype = np.dtype(getattr(t, "dtype", a.dtype))
            if dtype == jnp.bfloat16 and a.dtype == np.uint16:
                a = a.view(dtype)
            if a.dtype != dtype or a.shape != np.shape(t):
                raise ValueError(
                    f"checkpoint {path} leaf {key} is {a.dtype}{a.shape}, "
                    f"expected {dtype}{np.shape(t)}")
            leaves.append(a)
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_checkpoint(dirname: str, state, extra_meta: Optional[dict] = None,
                    aux: Optional[dict] = None) -> str:
    meta = {"step": int(state.step), "backend": "npz"}
    if extra_meta:
        meta.update(extra_meta)
    path = os.path.join(dirname, CKPT_NAME)
    meta_path = os.path.join(dirname, META_NAME)
    # Unique tmp names + a process-wide lock: the sync (plot-cadence) and
    # async (--checkpoint_every) savers may race; writes must not interleave
    # and os.replace keeps every installed file atomic — a preempted save
    # never corrupts an existing checkpoint or its metadata.
    suffix = _tmp_suffix()
    with _write_lock:
        # Never replace a newer checkpoint with an older one (a queued async
        # save can run after a later sync save — possibly via the OTHER
        # backend; the shared meta file is the ordering authority).
        cur = _read_meta(dirname)
        if cur is not None and cur.get("step", -1) > meta["step"]:
            return path
        # Stage EVERYTHING first, then retain, then install: a kill at any
        # point leaves either the old trio, the old trio under .prev, or the
        # new trio — never a directory without a restorable checkpoint
        # (restore_checkpoint falls back to .prev if the current ckpt file
        # is missing mid-swap).
        tmp = path + suffix
        _write_npz(tmp, state)
        atmp = None
        if aux is not None:
            # stamp the step: the three files are individually atomic but
            # not jointly — a kill between replaces pairs a newer state
            # with stale aux; consumers compare aux["step"] to the restored
            # state's step and fall back to a state-only resume on mismatch
            import pickle

            atmp = os.path.join(dirname, AUX_NAME) + suffix
            with open(atmp, "wb") as f:
                pickle.dump({**aux, "step": meta["step"]}, f)
        mtmp = meta_path + suffix
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        # Retention: set the current trio aside as .prev before installing
        # (only when this save genuinely advances the step — a same-step
        # re-save must not clobber a meaningful .prev with a duplicate).
        if cur is not None and cur.get("step", -1) < meta["step"]:
            for p in (path, os.path.join(dirname, AUX_NAME), meta_path):
                if os.path.exists(p):
                    os.replace(p, p + PREV_SUFFIX)
        # Install; meta last — it is the ordering authority.
        os.replace(tmp, path)
        if atmp is not None:
            os.replace(atmp, os.path.join(dirname, AUX_NAME))
        os.replace(mtmp, meta_path)
    return path


def save_checkpoint_async(dirname: str, state, extra_meta: Optional[dict] = None,
                          backend: str = "npz", aux: Optional[dict] = None):
    """Non-blocking checkpoint: snapshot to host now, serialize + write on a
    background thread so training never stalls on disk I/O. Returns a
    future; writes are serialized on one worker so checkpoints never
    interleave. ``backend`` matches --ckpt_backend so async (off-cadence)
    and sync (plot-cadence) saves land in the same format. ``aux`` must
    already be a stable host snapshot (the caller owns that)."""
    _raise_pending_async_error()
    snapshot = jax.device_get(state)
    saver = save_checkpoint_orbax if backend == "orbax" else save_checkpoint
    fut = _executor().submit(saver, dirname, snapshot, extra_meta, aux)
    fut.add_done_callback(_record_async_failure)
    return fut


def _record_async_failure(fut) -> None:
    global _async_error
    exc = fut.exception()
    if exc is not None:
        print(f"[checkpoint] background save FAILED: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)
        if _async_error is None:
            _async_error = exc


def _raise_pending_async_error() -> None:
    global _async_error
    if _async_error is not None:
        exc, _async_error = _async_error, None
        raise RuntimeError(
            "a previous background checkpoint save failed — checkpointing "
            "is broken, refusing to continue silently"
        ) from exc


def wait_for_pending_saves() -> None:
    """Block until every queued async checkpoint write has landed (the
    writer is a single-worker executor, so a barrier task suffices), and
    surface any background save failure."""
    _executor().submit(lambda: None).result()
    _raise_pending_async_error()


def restore_checkpoint(dirname: str, state_template):
    """Restore the NEWEST checkpoint in ``dirname``.

    Both backends write the shared ``ckpt_meta.json`` under the step-ordering
    guard, so its ``backend`` field always names the artifact holding the
    newest state — honor it rather than preferring one format (a stale
    npz async save must not shadow a newer orbax sync save)."""
    meta = _read_meta(dirname)
    npz_path = os.path.join(dirname, CKPT_NAME)
    orbax_path = os.path.join(dirname, ORBAX_NAME)
    have_orbax = (os.path.exists(orbax_path)
                  or os.path.exists(orbax_path + ".old"))
    backend = (meta or {}).get("backend")
    if backend == "orbax" and have_orbax:
        return restore_checkpoint_orbax(dirname, state_template)
    if backend == "npz" and os.path.exists(npz_path):
        pass  # fall through to the npz read below
    elif not os.path.exists(npz_path) and have_orbax:
        return restore_checkpoint_orbax(dirname, state_template)
    if (not os.path.exists(npz_path)
            and os.path.exists(npz_path + PREV_SUFFIX)):
        # killed between the retention set-aside and the install: the
        # retained trio is the only complete checkpoint
        npz_path += PREV_SUFFIX
    return _read_npz(npz_path, state_template)


def restore_checkpoint_prev(dirname: str, state_template):
    """Restore the RETAINED previous npz checkpoint (the save before the
    newest one). Raises OSError if no .prev checkpoint exists. Used by the
    grid rollback path when a SIGKILL left rows at different steps."""
    return _read_npz(os.path.join(dirname, CKPT_NAME + PREV_SUFFIX),
                     state_template)


def promote_prev_checkpoint(dirname: str) -> None:
    """Install the retained .prev trio as the CURRENT checkpoint, discarding
    the newer save (grid rollback: the newer save belongs to a killed run's
    future that the rest of the grid never reached — left in place, its
    meta step would make the ordering guard refuse every subsequent save).

    Order meta → aux → ckpt: meta is the ordering authority, so dropping it
    first means a kill mid-promotion leaves a state the NEXT restore handles
    (ckpt still newer than meta ⇒ the rollback path re-engages off the
    still-present .prev members; each os.replace is atomic)."""
    for name in (META_NAME, AUX_NAME, CKPT_NAME):
        p = os.path.join(dirname, name)
        pv = p + PREV_SUFFIX
        if os.path.exists(pv):
            os.replace(pv, p)


def checkpoint_exists(dirname: str) -> bool:
    orbax = os.path.join(dirname, ORBAX_NAME)
    npz = os.path.join(dirname, CKPT_NAME)
    return (os.path.exists(npz)
            or os.path.exists(npz + PREV_SUFFIX)
            or os.path.exists(orbax) or os.path.exists(orbax + ".old"))


# ---------------------------------------------------------------------------
# Orbax backend (ecosystem-standard checkpoint format; --ckpt_backend orbax;
# orbax is an optional dependency, imported only here)
# ---------------------------------------------------------------------------

ORBAX_NAME = "orbax_ckpt"


def save_checkpoint_orbax(dirname: str, state,
                          extra_meta: Optional[dict] = None,
                          aux: Optional[dict] = None) -> str:
    """Orbax StandardCheckpointer save — interoperable with standard JAX
    tooling (tensorstore-backed, sharding-aware)."""
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(dirname, ORBAX_NAME))
    tmp_path = path + ".new"
    old_path = path + ".old"
    import shutil

    with _write_lock:
        # Same step-ordering guard as the npz saver: a queued async save
        # (either backend) must never shadow a newer checkpoint.
        prev = _read_meta(dirname)
        if prev is not None and prev.get("step", -1) > int(state.step):
            return path
        if os.path.exists(tmp_path):
            shutil.rmtree(tmp_path)
        if os.path.exists(old_path):
            if not os.path.exists(path):
                # A prior save was preempted mid-swap: the set-aside .old is
                # the ONLY surviving checkpoint. Promote it back to `path`
                # (restore_checkpoint_orbax would read it from .old anyway)
                # rather than deleting it — rmtree here followed by a second
                # preemption during the multi-second ckptr.save would leave
                # the run with zero checkpoints.
                os.replace(old_path, path)
            else:
                shutil.rmtree(old_path)
        ckptr = ocp.StandardCheckpointer()
        ckptr.save(tmp_path, jax.device_get(state))
        ckptr.wait_until_finished()
        # Directory swap that never leaves the run without a checkpoint:
        # rename the old one ASIDE (not rmtree — a preemption between a
        # delete and the install would destroy the only copy), install the
        # new one, then delete the old. A kill mid-sequence leaves either
        # the old ckpt at `path` or the new one; never neither.
        if os.path.exists(path):
            os.replace(path, old_path)
        os.replace(tmp_path, path)
        if os.path.exists(old_path):
            shutil.rmtree(old_path)
        if aux is not None:
            _write_aux(dirname, {**aux, "step": int(state.step)},
                       _tmp_suffix())
        meta = {"step": int(state.step), "backend": "orbax"}
        if extra_meta:
            meta.update(extra_meta)
        mtmp = os.path.join(dirname, META_NAME + ".tmp")
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, os.path.join(dirname, META_NAME))
    return path


def restore_checkpoint_orbax(dirname: str, state_template):
    import orbax.checkpoint as ocp

    path = os.path.abspath(os.path.join(dirname, ORBAX_NAME))
    if not os.path.exists(path) and os.path.exists(path + ".old"):
        # preempted mid-swap (old renamed aside, new not yet installed):
        # the set-aside directory is a complete, valid checkpoint
        path = path + ".old"
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(path, jax.device_get(state_template))
