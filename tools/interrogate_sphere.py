#!/usr/bin/env python
"""Interrogate the 4 non-collapsed sphere sweep rows.

The full-sweep reproduction converges 11/15 sphere rows; dd5_pd16 (three
dataset seeds) and dd7_pd7 seed48 plateau at padding ≈ 0.49-0.77. This
probes whether that is the paper's landscape phenomenon (plateau for every
init / precision / horizon) or a framework artifact (some variant
collapses):
  - baseline: model_seed 0, bf16, 150k steps (the sweep configuration);
  - (a) model_seed ∈ {1, 2, 3} — different init basins;
  - (b) --precision fp32 — true-fp32 dots vs the backend-default dots;
  - (c) a 300k-step extension — double the training horizon.

Idempotent: finished runs (complete losses.npz) are skipped, so an
interrupted campaign resumes by re-invoking. Prints a markdown table of
final Padding Error / Sphere Error / smoothed loss per (row, variant).
Run on the GPU:

    python tools/interrogate_sphere.py [--data_dir data/probe_sphere]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

# the four plateau rows: (data_dim, padding_dim, latent_dim, dataset_seed)
ROWS = [(5, 16, 16, 69), (5, 16, 16, 24), (5, 16, 16, 48), (7, 7, 13, 48)]

# (tag, model_seed, precision, num_batches)
VARIANTS = [
    ("ms0", 0, "bf16", 150_000),
    ("ms1", 1, "bf16", 150_000),
    ("ms2", 2, "bf16", 150_000),
    ("ms3", 3, "bf16", 150_000),
    ("fp32", 0, "fp32", 150_000),
    ("300k", 0, "bf16", 300_000),
]


def make_cfg(dd, pd, ld, ds_seed, tag, model_seed, precision, num_batches,
             data_dir):
    from vae_training_tpu.config import RunConfig

    return RunConfig(
        name=f"probe_dd{dd}_pd{pd}_ld{ld}_s{ds_seed}_{tag}",
        dataset="sphere", encoder_layer_sizes="200|200|200",
        layer_sizes="200|200|200", latent_dimension=ld, padding_dim=pd,
        dataset_dimension=dd, num_batches=num_batches, epsilon=-3.0,
        tunable_decoder_var=True, dataset_seed=ds_seed,
        model_seed=model_seed, precision=precision, overwrite=True,
        tqdm=False, data_dir=data_dir,
    ).validate()


def run_done(out, num_batches):
    fn = os.path.join(out, "losses.npz")
    if not os.path.exists(fn):
        return False
    try:
        z = np.load(fn, allow_pickle=True)
        return z["VAE Loss"].shape[0] >= num_batches
    except Exception:
        return False


def final_metrics(out):
    z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
    losses = np.asarray(z["VAE Loss"], np.float64)
    pad = float(np.asarray(z["Padding Error"])[-1])
    sph = float(np.asarray(z["Sphere Error"])[-1])
    smoothed = float(losses[-2000:].mean())
    return pad, sph, smoothed


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_dir", default="data/probe_sphere")
    args = p.parse_args()
    os.makedirs(args.data_dir, exist_ok=True)

    from run import main as run_main
    from vae_training_tpu.runio import enable_compile_cache

    enable_compile_cache()
    results = []
    for dd, pd, ld, ds_seed in ROWS:
        for tag, ms, prec, nb in VARIANTS:
            cfg = make_cfg(dd, pd, ld, ds_seed, tag, ms, prec, nb,
                           args.data_dir)
            out = os.path.join(args.data_dir, cfg.name)
            if not run_done(out, nb):
                print(f"[probe] running {cfg.name}", flush=True)
                try:
                    run_main(cfg)  # returns 0 or raises
                except Exception as e:
                    # log-and-continue: one flaky/NaN run must not abort
                    # the campaign; the skipped run reruns on re-invocation
                    print(f"[probe] {cfg.name} FAILED "
                          f"({type(e).__name__}: {e})", flush=True)
                    continue
            pad, sph, smoothed = final_metrics(out)
            row = (f"dd{dd}_pd{pd}_s{ds_seed}", tag, pad, sph, smoothed)
            results.append(row)
            print(f"[probe] {row[0]} {tag}: padding={pad:.4f} "
                  f"sphere={sph:.5f} loss={smoothed:+.3f}", flush=True)

    print("\n| row | variant | final padding | sphere err | smoothed loss |")
    print("|---|---|---|---|---|")
    for name, tag, pad, sph, smoothed in results:
        print(f"| {name} | {tag} | {pad:.4f} | {sph:.5f} | {smoothed:+.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
