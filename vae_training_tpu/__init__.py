"""vae_training_tpu — a VAE training framework on JAX/XLA.

A ground-up JAX/XLA re-design with the capabilities of the reference
codebase `virajmehta/vae-training`: VAE training
on synthetic low-intrinsic-dimension manifolds (sphere / linear-gaussian /
sigmoid, plus gaussian) embedded in padded ambient space, with ELBO
decomposition stats, analytic manifold scoring, diagnostic plots, and
checkpointing — architected accelerator-first:

- all per-step work (on-device data sampling, reparameterisation, ELBO
  forward/backward, Adam update) lives inside ONE compiled, donated-buffer
  XLA program, chunked over ``lax.scan`` so the host only wakes at eval
  cadence (the reference dispatches ~10 small device ops per step from
  Python: reference/model.py:221-222, reference/vae.py:123-129);
- a whole sweep row's seeds train as one vmapped program (``--seed_grid``);
- scale-out is a ``jax.sharding.Mesh`` + shard_map/GSPMD with XLA
  collectives, not a communication library.

Public layers (mirrors SURVEY.md §1's layer map, rebuilt):

- ``config``    — typed run config + the reference's exact CLI flag surface
- ``data``      — pure-function dataset samplers + analytic scoring oracles
- ``models``    — the VAE as plain jax functions over param dicts (encoder /
                  global posterior log-var / dual sigmoid decoder / output
                  noise) + warm-start inits
- ``ops``       — ELBO math, pure-JAX image tiling, subspace metrics
- ``train``     — TrainState, fused scan train step, the training engine
- ``parallel``  — mesh construction, DP shard_map chunk, GSPMD shardings
- ``evals``     — stat aggregation / console writer, plotting
- ``runio``     — output dirs, args.json manifest, checkpoints, exports
- ``reference`` — an independent float32 reference of one training step
"""

__version__ = "0.1.0"
