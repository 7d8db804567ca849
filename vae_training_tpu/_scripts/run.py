#!/usr/bin/env python
"""CLI entry point — the reference's public UX, backed by the compiled engine.

``python run.py <name> --dataset linear_gaussian ...`` with the exact flag
surface of reference/run.py:8-43 (see vae_training_tpu/config.py),
plus framework flags (--mesh, --seed_grid, --resume, --profile).

Pipeline mirrors reference/run.py:350-369: output dir + args.json →
dataset → model/trainer → train → plot → final save. ``-nojit`` disables
compilation for step-through debugging; ``--debug_nans`` enables
jax_debug_nans.
"""

from __future__ import annotations

import os
import sys

from vae_training_tpu.config import RunConfig, parse_arguments
from vae_training_tpu.data import get_dataset
from vae_training_tpu.runio import make_output_dir
from vae_training_tpu.train import Trainer


def main(cfg: RunConfig) -> int:
    import jax

    from vae_training_tpu.runio import enable_compile_cache

    enable_compile_cache()
    # Validate BEFORE the distributed handshake: config errors (unknown
    # dataset, the orbax×multihost rejection, bad mesh specs) must fail
    # fast on each process rather than after — or worse, inside — a
    # jax.distributed.initialize that blocks waiting for peers.
    cfg.validate()
    if cfg.multihost:
        # MUST run before any backend touch (jax.devices() below would
        # otherwise initialize a single-process backend and the mesh could
        # never span hosts). Process identity: explicit env vars when set
        # (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID —
        # manual bring-up, incl. the multi-process CPU test), else jax's
        # cluster auto-detection (SLURM, MPI). Mesh axes
        # then span all hosts' devices; process 0 owns artifact writes
        # (utils/process.is_primary).
        kw = {}
        if os.environ.get("JAX_COORDINATOR_ADDRESS"):
            kw = dict(
                coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
                num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
                process_id=int(os.environ["JAX_PROCESS_ID"]),
            )
        jax.distributed.initialize(**kw)
    print(f"devices: {jax.devices()}", file=sys.stderr, flush=True)
    if cfg.seed_grid:
        from vae_training_tpu.train.grid import run_seed_grid

        seeds = [int(s) for s in cfg.seed_grid.split(",") if s.strip()]
        return run_seed_grid(cfg, seeds)
    # Resuming IN PLACE (e.g. a supervised retry after preemption — the
    # resume path IS this run's own output dir) must reuse the existing
    # directory without clobber protection. Resuming FROM a different
    # run's checkpoint into a fresh name keeps the reference's
    # refuse-to-clobber guarantee: an existing <name> still requires -ow.
    own_dir = os.path.join(cfg.data_dir or "data", cfg.name)
    # realpath (not abspath): a symlinked data dir must still classify
    # --resume <same run via the other path> as in-place — a false
    # "foreign" here plus -ow would wipe the very checkpoint being resumed
    resume_in_place = bool(cfg.resume) and (
        os.path.realpath(cfg.resume) == os.path.realpath(own_dir))
    if (cfg.resume and not resume_in_place and cfg.overwrite
            and (os.path.realpath(cfg.resume) + os.sep).startswith(
                os.path.realpath(own_dir) + os.sep)):
        raise ValueError(
            f"--resume {cfg.resume} lies inside the output dir {own_dir} "
            f"that -ow would wipe; resume in place (--resume {own_dir}) "
            f"or pick a different run name")
    output_dir = make_output_dir(
        cfg.name, cfg.overwrite, cfg, data_dir=cfg.data_dir,
        reuse_existing=resume_in_place,
    )
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    if cfg.data_fn:
        # reference parity: --data_fn loads a persisted dataset/manifold
        # (the reference wired but never called this — model.py:91-94)
        loaded = dataset.load(cfg.data_fn)
        dataset = loaded if loaded is not None else dataset
    trainer = Trainer(cfg, dataset, output_dir)
    trainer.train()
    trainer.plot()
    trainer.save(final=True)
    return 0


def cli() -> int:
    """Console entry point (``vae-train``) — identical to ``python run.py``:
    parse the reference flag surface, honor -nojit/--debug_nans, run."""
    import jax

    cfg = parse_arguments()
    if cfg.debug_nans:
        jax.config.update("jax_debug_nans", True)
    if cfg.nojit:
        with jax.disable_jit():
            return main(cfg)
    return main(cfg)


if __name__ == "__main__":
    sys.exit(cli())
