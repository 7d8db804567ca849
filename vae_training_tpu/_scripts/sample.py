#!/usr/bin/env python
"""Generate samples from a trained run directory (the serving path).

    python sample.py data/<run_name> -n 1000 -o samples.npz [--png tile.png]

Rebuilds the model from the run's ``args.json`` manifest, restores
parameters from its checkpoint (``ckpt.npz``; falls back to the
reference-layout ``model.pkl``), draws prior latents, and runs the jitted
ancestral-sampling path once. Outputs an .npz of samples (+ the latents
used) and optionally a diagnostic plot via the dataset's plotter.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def load_run(run_dir: str):
    from vae_training_tpu.config import RunConfig
    from vae_training_tpu.data import get_dataset
    from vae_training_tpu.train import Trainer

    with open(os.path.join(run_dir, "args.json")) as f:
        manifest = json.load(f)
    known = {k: v for k, v in manifest.items() if k in RunConfig.__dataclass_fields__}
    cfg = RunConfig(**known)
    cfg.resume = None
    cfg.state_dict = None
    cfg.mesh = ""  # sampling is single-device
    cfg.validate()
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    trainer = Trainer(cfg, dataset, run_dir)

    from vae_training_tpu.runio import checkpoint_exists, restore_checkpoint
    from vae_training_tpu.runio.export import load_model_pkl

    if checkpoint_exists(run_dir):
        trainer.state = restore_checkpoint(run_dir, trainer.state)
    else:
        pkl = os.path.join(run_dir, "model.pkl")
        params, opt_state = load_model_pkl(pkl, trainer.state.params,
                                           trainer.state.opt_state)
        trainer.state = trainer.state.replace(params=params, opt_state=opt_state)
    # thread the learned decoder log-variance into generation
    eps = trainer.state.params.get("epsilon")
    if eps is not None and cfg.tunable_decoder_var:
        trainer.current_epsilon = np.asarray(eps) * cfg.epsilon
    return trainer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_dir", help="A run output directory (contains args.json)")
    p.add_argument("-n", "--num_samples", type=int, default=1000)
    p.add_argument("-o", "--out", default=None,
                   help="Output .npz (default: <run_dir>/samples.npz)")
    p.add_argument("--png", default=None,
                   help="Also write a diagnostic plot to this path.")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import jax

    trainer = load_run(args.run_dir)
    key = jax.random.PRNGKey(args.seed)
    samples, latents = trainer.sample_batch(key, args.num_samples)
    out = args.out or os.path.join(args.run_dir, "samples.npz")
    np.savez(out, samples=np.asarray(samples), latents=np.asarray(latents))
    print(f"wrote {args.num_samples} samples to {out}")
    score = trainer.dataset.score_batch(samples)
    if isinstance(score, dict) and score:
        print("scores:", {k: float(np.asarray(v).mean()) for k, v in score.items()})
    if args.png:
        trainer.dataset.plot_batch(np.asarray(samples), fn=args.png)
        print(f"wrote plot to {args.png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
