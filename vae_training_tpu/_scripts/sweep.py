#!/usr/bin/env python
"""Run an entire reference sweep grid in ONE process.

The ``*_expts.sh`` scripts remain the reference-compatible API (one process
per run); this runner executes the same grids in a single process so
compiled programs are shared across rows and seeds — with the persistent
compile cache, the whole 21-run linear sweep costs a handful of compiles
instead of 21× cold starts.

    python sweep.py linear   # 21 runs of seed_linpadding_expts.sh
    python sweep.py sigmoid  # 18 runs of sigmoid_vae_padding_expts.sh
    python sweep.py sphere   # 15 runs of sphere_vae_padding_expts.sh

Multi-host: ``--shard K/N`` trains a disjoint round-robin share of the
sweep, so N hosts each run one process — zero collectives, no distributed
runtime (docs/architecture.md, Scale-out).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

from vae_training_tpu.config import RunConfig

# (data_dim, padding_dim, latent_dim) rows — identical grids to the shell
# scripts / the reference's sweeps.
LINEAR_GRID = [(3, 9, 20), (3, 17, 20), (6, 6, 20), (6, 14, 20),
               (9, 3, 20), (9, 11, 10), (12, 8, 10)]
SIGMOID_GRID = [(3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10),
                (7, 7, 13), (7, 20, 24)]
SPHERE_GRID = [(3, 3, 6), (3, 13, 8), (5, 16, 16), (5, 5, 10), (7, 7, 13)]


def sweep_configs(sweep: str, data_dir: str, num_batches: int | None,
                  adam_dtype: str = "f32"):
    if sweep == "linear":
        for seed in (2, 3, 4):
            for dd, pd, ld in LINEAR_GRID:
                yield RunConfig(
                    name=f"vae{dd}linear_gaussian_{dd + pd}dim{seed}",
                    dataset="linear_gaussian", encoder_layer_sizes="",
                    layer_sizes="", overwrite=True, latent_dimension=ld,
                    padding_dim=pd, dataset_dimension=dd,
                    num_batches=num_batches or 100000, epsilon=-1.0,
                    tunable_decoder_var=True, dataset_seed=seed,
                    learning_rate=1e-3, data_dir=data_dir,
                    tqdm=False, adam_dtype=adam_dtype,
                )
    elif sweep == "sigmoid":
        for seed in (None, 24, 48):
            for dd, pd, ld in SIGMOID_GRID:
                name = f"sigmoid_dd{dd}_pd{pd}_ld_{ld}_eps-3"
                if seed is not None:
                    name += f"_seed{seed}"
                yield RunConfig(
                    name=name, dataset="sigmoid", encoder_layer_sizes="",
                    layer_sizes="", overwrite=True, latent_dimension=ld,
                    padding_dim=pd, dataset_dimension=dd,
                    num_batches=num_batches or 150000, epsilon=-3.0,
                    tunable_decoder_var=True,
                    dataset_seed=seed if seed is not None else 69,
                    data_dir=data_dir, tqdm=False, adam_dtype=adam_dtype,
                )
    elif sweep == "sphere":
        for seed in (None, 24, 48):
            for dd, pd, ld in SPHERE_GRID:
                name = f"sphere_dd{dd}_pd{pd}_ld_{ld}_eps-3"
                if seed is not None:
                    name += f"_seed{seed}"
                yield RunConfig(
                    name=name, dataset="sphere",
                    encoder_layer_sizes="200|200|200",
                    layer_sizes="200|200|200", overwrite=True,
                    latent_dimension=ld, padding_dim=pd,
                    dataset_dimension=dd,
                    num_batches=num_batches or 150000, epsilon=-3.0,
                    tunable_decoder_var=True,
                    dataset_seed=seed if seed is not None else 69,
                    data_dir=data_dir, tqdm=False, adam_dtype=adam_dtype,
                )
    else:
        raise ValueError(f"unknown sweep {sweep!r}")


def cfg_to_argv(cfg: RunConfig):
    """Render a RunConfig back into a reference-style run.py invocation."""
    argv = [
        cfg.name, "--dataset", cfg.dataset,
        "--encoder_layer_sizes", cfg.encoder_layer_sizes,
        "--layer_sizes", cfg.layer_sizes,
        "--latent_dim", str(cfg.latent_dimension),
        "--padding_dim", str(cfg.padding_dim),
        "-dd", str(cfg.dataset_dimension),
        "--num_batches", str(cfg.num_batches),
        "--batch_size", str(cfg.batch_size),
        "--epsilon", str(cfg.epsilon),
        "-ds", str(cfg.dataset_seed),
        "-lr", str(cfg.learning_rate),
        "--data_dir", cfg.data_dir,
        "--checkpoint_every", str(cfg.checkpoint_every),
        "--adam_dtype", cfg.adam_dtype,
    ]
    if cfg.tunable_decoder_var:
        argv.append("-tdv")
    if cfg.overwrite:
        argv.append("-ow")
    return argv


def run_isolated(cfg: RunConfig, timeout: float, retries: int) -> bool:
    """Run one row as a subprocess with a wall-clock limit: on a timeout or
    crash, retry, resuming from the row's checkpoint if one exists. Rows
    run one at a time — a JAX process reserves most of the device's memory,
    so only one may hold the device."""
    from vae_training_tpu.runio.checkpoint import checkpoint_exists

    run_dir = os.path.join(cfg.data_dir, cfg.name)
    # the -m child must resolve vae_training_tpu even when this runner was
    # invoked as a bare script from another directory without an install
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = (pkg_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else pkg_root)
    for attempt in range(retries + 1):
        argv = cfg_to_argv(cfg)
        # checkpoint_exists (not a bare ckpt.npz stat): a kill between the
        # retention set-aside and the install leaves only the .prev trio,
        # which restore_checkpoint reads — a raw file check would miss it
        # and RESTART the row with -ow, wiping that last state
        if attempt > 0 and checkpoint_exists(run_dir):
            argv = [a for a in argv if a != "-ow"] + ["--resume", run_dir]
        note = f"{cfg.name} attempt {attempt + 1}/{retries + 1}"
        try:
            rc = subprocess.run(
                [sys.executable, "-m", "vae_training_tpu._scripts.run"] + argv,
                env=env, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            print(f"[sweep] {note}: run exceeded {timeout:.0f}s; killed",
                  file=sys.stderr, flush=True)
            continue
        if rc == 0:
            return True
        print(f"[sweep] {note} exited {rc}", flush=True)
    return False


SWEEP_SEEDS = {"linear": [2, 3, 4], "sigmoid": [69, 24, 48],
               "sphere": [69, 24, 48]}


def parse_shard(spec: str):
    """``'K/N'`` → (k, n). Sweeps have ZERO cross-row communication, so the
    multi-host shape is N INDEPENDENT processes (one per host), each
    training a disjoint share — no distributed runtime, no collectives, no
    shared-filesystem requirement beyond the output dir. Round-robin by
    position so shards stay balanced across the mixed-dimension rows."""
    if not spec:
        return 0, 1
    try:
        k_s, n_s = spec.split("/", 1)
        k, n = int(k_s), int(n_s)
    except ValueError:
        raise SystemExit(f"--shard expects 'K/N', got {spec!r}")
    if n < 1 or not 0 <= k < n:
        raise SystemExit(f"--shard {spec!r}: need 0 <= K < N")
    return k, n


def shard_items(items, shard):
    k, n = shard
    return [x for i, x in enumerate(items) if i % n == k]


def run_grouped(sweep: str, data_dir: str, num_batches, mesh: str = "",
                resume: bool = False, adam_dtype: str = "f32",
                shard=(0, 1)) -> int:
    """Max-speed sweep: each row's seeds train as ONE grid launch, reusing
    the reference run names. The linear sweep's 21 runs collapse to 7
    launches. With ``mesh`` (e.g. 'dp=3'), each launch's seed axis is
    sharded over the device mesh — every device trains its own rows, zero
    collectives."""
    from vae_training_tpu.train.grid import run_seed_grid

    seeds = SWEEP_SEEDS[sweep]
    rows = {}
    for cfg in sweep_configs(sweep, data_dir, num_batches, adam_dtype):
        key = (cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension)
        rows.setdefault(key, {})[cfg.dataset_seed] = cfg
    if shard != (0, 1):
        # --shard K/N partitions the ROW GROUPS (each group = one
        # (dd,pd,ld) row x all seeds, the one-launch unit) round-robin
        keep = shard_items(list(rows), shard)
        rows = {k: rows[k] for k in keep}
        print(f"[sweep] shard {shard[0]}/{shard[1]}: "
              f"{len(rows)} row groups {sorted(rows)}", flush=True)
        if not rows:
            print("[sweep] shard owns no rows; nothing to do", flush=True)
            return 0

    for key, by_seed in rows.items():
        cfgs = [by_seed[s] for s in seeds]
        names = {s: c.name for s, c in zip(seeds, cfgs)}
        cfgs[0].mesh = mesh
        if resume:
            cfgs[0].resume = "rows"  # grid semantics: each row's own outdir
        t0 = time.perf_counter()
        run_seed_grid(cfgs[0], seeds, name_fn=lambda s: names[s])
        print(f"[sweep] row dd={key[0]} pd={key[1]} ld={key[2]} "
              f"({len(seeds)} seeds) done in {time.perf_counter() - t0:.1f}s",
              flush=True)
    return 0


# Primary convergence channel per family; threshold matches the published
# plots' collapse criterion (padding energy -> 0).
REPORT_CHANNELS = {
    "linear": "Squared Norm of padding dimensions",
    "sigmoid": "Squared Norm of Padding Dimensions",
    "sphere": "Padding Error",
}


def run_report(sweep: str, data_dir: str, threshold: float = 0.01) -> int:
    """Summarize a finished sweep from its artifacts (host-only, no device):
    per-row final smoothed loss + padding channel + converged?, and a
    family total. This is the table PARITY.md's full-sweep reproduction
    section is built from. Returns 1 if any row's artifacts are missing."""
    import numpy as np

    channel = REPORT_CHANNELS[sweep]
    rows, missing, converged = [], [], 0
    for cfg in sweep_configs(sweep, data_dir, None):
        path = os.path.join(data_dir, cfg.name, "losses.npz")
        try:
            # a preempted row can leave a truncated npz (np.savez is not
            # atomic) — report it under MISSING, don't abort the table
            z = np.load(path, allow_pickle=True)
            loss = np.asarray(z["VAE Loss"], np.float64)
            pad = np.asarray(z[channel], np.float64).reshape(-1)
        except Exception as e:
            missing.append(f"{cfg.name} ({type(e).__name__})")
            continue
        final_loss = (float(loss[-min(100, loss.size):].mean())
                      if loss.size else float("nan"))
        final_pad = float(pad[-1]) if pad.size else float("nan")
        ok = final_pad < threshold
        converged += bool(ok)
        rows.append((cfg.name, final_loss, final_pad, ok))
    name_w = max((len(r[0]) for r in rows), default=4)
    print(f"{'run':<{name_w}}  {'final loss':>12}  {'padding':>12}  conv")
    for name, fl, fp, ok in rows:
        print(f"{name:<{name_w}}  {fl:>12.4f}  {fp:>12.6f}  "
              f"{'yes' if ok else 'NO'}")
    print(f"[report] {sweep}: {converged}/{len(rows)} rows converged "
          f"({channel} < {threshold})"
          + (f"; MISSING: {missing}" if missing else ""), flush=True)
    return 1 if missing else 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("sweep", choices=["linear", "sigmoid", "sphere"])
    p.add_argument("--data_dir", default="data")
    p.add_argument("--num_batches", type=int, default=None,
                   help="Override the sweep's per-run step count.")
    p.add_argument("--grouped", action="store_true",
                   help="Train each row's seeds as ONE grid launch.")
    p.add_argument("--mesh", default="",
                   help="With --grouped: shard each launch's seed axis over "
                        "a device mesh, e.g. 'dp=3' (seed count must divide "
                        "evenly).")
    p.add_argument("--resume", action="store_true",
                   help="With --grouped: continue a preempted sweep from "
                        "every row's own checkpoint (artifacts come out "
                        "identical to an uninterrupted sweep).")
    p.add_argument("--isolate", action="store_true",
                   help="Run each row as a subprocess with a wall-clock "
                        "limit, retrying from the row's checkpoint after a "
                        "timeout or crash (one row at a time).")
    p.add_argument("--row_timeout", type=float, default=900.0,
                   help="Per-attempt wall-clock limit with --isolate.")
    p.add_argument("--retries", type=int, default=2)
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="Off-cadence async checkpoints (useful with "
                        "--isolate so retries resume mid-run).")
    p.add_argument("--adam_dtype", default="f32", choices=["f32", "bf16"],
                   help="Adam moment storage for every row (see run.py "
                        "--adam_dtype); used for the bf16 convergence "
                        "validation sweeps.")
    p.add_argument("--report", action="store_true",
                   help="Summarize a FINISHED sweep from its artifacts "
                        "(per-row final loss + padding channel + "
                        "converged?); host-only, touches no device.")
    p.add_argument("--shard", default="",
                   help="'K/N': train only this process's round-robin share "
                        "of the sweep (row groups with --grouped, runs "
                        "otherwise). Sweeps have zero cross-row "
                        "communication, so the multi-host shape is N "
                        "independent sweep.py processes, one per host — "
                        "no distributed runtime needed; "
                        "shards write disjoint run directories. Ignored by "
                        "--report (which summarizes the whole sweep).")
    args = p.parse_args(argv)
    shard = parse_shard(args.shard)

    if args.report:
        return run_report(args.sweep, args.data_dir)

    if args.grouped:
        if args.isolate:
            raise SystemExit("--grouped and --isolate are mutually exclusive")
        from vae_training_tpu.runio import enable_compile_cache

        enable_compile_cache()
        t0 = time.perf_counter()
        rc = run_grouped(args.sweep, args.data_dir, args.num_batches,
                         mesh=args.mesh, resume=args.resume,
                         adam_dtype=args.adam_dtype, shard=shard)
        print(f"[sweep] grouped {args.sweep} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        return rc

    t0 = time.perf_counter()
    count, failed = 0, []
    runner = None
    if not args.isolate:
        from vae_training_tpu._scripts.run import main as run_one

        runner = run_one
    all_cfgs = list(sweep_configs(args.sweep, args.data_dir,
                                  args.num_batches, args.adam_dtype))
    cfgs = shard_items(all_cfgs, shard)
    if shard != (0, 1):
        print(f"[sweep] shard {shard[0]}/{shard[1]}: {len(cfgs)} of "
              f"{len(all_cfgs)} runs", flush=True)
    for cfg in cfgs:
        cfg.checkpoint_every = args.checkpoint_every
        t1 = time.perf_counter()
        if args.isolate:
            ok = run_isolated(cfg, args.row_timeout, args.retries)
        else:
            ok = runner(cfg) == 0
        count += 1
        status = "done" if ok else "FAILED"
        if not ok:
            failed.append(cfg.name)
        print(f"[sweep] {cfg.name} {status} in {time.perf_counter() - t1:.1f}s",
              flush=True)
    print(f"[sweep] {count} runs in {time.perf_counter() - t0:.1f}s"
          + (f"; FAILED: {failed}" if failed else ""), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
