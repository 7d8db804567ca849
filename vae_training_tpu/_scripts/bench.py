#!/usr/bin/env python
"""Training-throughput benchmark: steps/sec on one device, one JSON line.

Default workload = row 1 of reference/seed_linpadding_expts.sh
(linear encoder/decoder, ambient dim 12, latent 20, batch 100, Adam 1e-3,
tunable decoder variance). ``--config`` selects another sweep family's
row 1 (sigmoid, sphere), a whole sweep family trained as per-row seed
grids (grid_linear/grid_sigmoid/grid_sphere; the value is AGGREGATE
row-steps/sec), or the conv VAE in epoch mode. Prints ONE JSON line:

    {"metric": ..., "value": N, "unit": "steps/sec", "flops_per_step": N,
     "mfu_pct": N|null, "precision": ..., "device": {...}}

Diagnostics go to stderr. Runs only on a GPU: a measurement that finds no
GPU exits non-zero instead of timing another backend.
"""

from __future__ import annotations

import json
import sys
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp

# Steps per timed chunk: the engine's own chunk length between stat events
# (train/loop.py N_PRINT), so the bench times the program training runs.
CHUNK_STEPS = 5000


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# Sweep-representative configs (flags exactly as the reference's scripts
# set them): linear row 1, sigmoid row 1, sphere row 1.
CONFIGS = {
    "linear": dict(
        dataset="linear_gaussian", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=20, padding_dim=9, dataset_dimension=3,
        dataset_intrinsic_dimension=3, learning_rate=1e-3, epsilon=-1.0,
    ),
    "sigmoid": dict(
        dataset="sigmoid", encoder_layer_sizes="", layer_sizes="",
        latent_dimension=6, padding_dim=3, dataset_dimension=3,
        learning_rate=1e-4, epsilon=-3.0,
    ),
    "sphere": dict(
        dataset="sphere", encoder_layer_sizes="200|200|200",
        layer_sizes="200|200|200", latent_dimension=6, padding_dim=3,
        dataset_dimension=3, learning_rate=1e-4, epsilon=-3.0,
    ),
}


# Row-1 dataset seeds exactly as the scripts pass them: the linear script's
# first run uses -ds 2 (seed_linpadding_expts.sh), the sigmoid/sphere
# scripts' first runs pass no -ds (reference default 69, run.py:26) — so
# the bench's data manifolds (and its loss diagnostics) match reference
# runs of the same row.
CONFIG_SEEDS = {"linear": 2, "sigmoid": 69, "sphere": 69}


def make_cfg(config: str, precision: str = "bf16", adam_dtype: str = "f32"):
    from vae_training_tpu.config import RunConfig

    return RunConfig(
        name="bench",
        num_batches=100_000,
        batch_size=100,
        tunable_decoder_var=True,
        dataset_seed=CONFIG_SEEDS[config],
        tqdm=False,
        precision=precision,
        adam_dtype=adam_dtype,
        **CONFIGS[config],
    ).validate()


def build(config: str = "linear", precision: str = "bf16",
          adam_dtype: str = "f32"):
    from vae_training_tpu.data import get_dataset
    from vae_training_tpu.train import Trainer

    cfg = make_cfg(config, precision, adam_dtype)
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    return Trainer(cfg, dataset, output_dir=".")


def make_conv_cfg(precision: str = "bf16"):
    """Conv-VAE epoch-mode workload: 4096 synthetic 28x28 images (the
    MNIST-scale config of BASELINE.json config 5), conv stack 32|64."""
    from vae_training_tpu.config import RunConfig

    return RunConfig(
        name="bench_conv", dataset="image", image_source="synthetic",
        image_size=28, num_images=4096, num_epochs=10, batch_size=128,
        latent_dimension=16, conv_channels="32|64", learning_rate=1e-3,
        epsilon=-1.0, tunable_decoder_var=True, tqdm=False,
        precision=precision,
    ).validate()


def build_conv(precision: str = "bf16"):
    from vae_training_tpu.data import get_dataset
    from vae_training_tpu.train import Trainer

    cfg = make_conv_cfg(precision)
    dataset = get_dataset(cfg.dataset, 0, cfg)
    return Trainer(cfg, dataset, output_dir="."), dataset


def measure_conv(trainer, dataset, reps: int = 90) -> float:
    """Minibatch steps/sec of the compiled epoch program (one epoch = one
    device program)."""
    n_batches = dataset.n // trainer.cfg.batch_size
    state = trainer.state
    state, losses = trainer.epoch_chunk(state, jnp.asarray(0), n_batches)
    jax.block_until_ready(losses)
    t0 = time.perf_counter()
    for e in range(reps):
        state, losses = trainer.epoch_chunk(
            state, jnp.asarray(e + 1), n_batches)
    jax.block_until_ready((state, losses))
    dt = time.perf_counter() - t0
    log(f"final loss after bench chain: {float(losses[-1]):.3f}")
    log(f"epochs/sec: {reps / dt:.2f} ({n_batches} batches of "
        f"{trainer.cfg.batch_size} per epoch)")
    trainer.state = state
    return (reps * n_batches) / dt


def build_grid(precision: str = "bf16", family: str = "linear",
               adam_dtype: str = "f32"):
    """A whole sweep family: every (dd, pd, ld) row as one seed-grid
    launch over the family's seeds — linear 21 runs in 7 launches, sigmoid
    18 in 6, sphere 15 in 5."""
    from vae_training_tpu._scripts import sweep as sweep_mod
    from vae_training_tpu.train.grid import GridTrainer

    seeds = sweep_mod.SWEEP_SEEDS[family]
    rows = {}
    for cfg in sweep_mod.sweep_configs(family, "data", None):
        cfg.precision = precision
        cfg.adam_dtype = adam_dtype
        key = (cfg.dataset_dimension, cfg.padding_dim, cfg.latent_dimension)
        rows.setdefault(key, {})[cfg.dataset_seed] = cfg
    return SimpleNamespace(groups=[GridTrainer(by_seed[seeds[0]], seeds)
                                   for by_seed in rows.values()])


def measure_grid(sweep, chunk_steps: int = CHUNK_STEPS, reps: int = 2) -> float:
    """Aggregate row-steps/sec across every row of the family."""
    from vae_training_tpu.train.grid import per_group_chunk

    grids = tuple(g.state_grid for g in sweep.groups)
    grids, losses = per_group_chunk(sweep.groups, grids, chunk_steps)
    jax.block_until_ready(losses)  # warmup + compile
    t0 = time.perf_counter()
    for _ in range(reps):
        grids, losses = per_group_chunk(sweep.groups, grids, chunk_steps)
    jax.block_until_ready((grids, losses))
    dt = time.perf_counter() - t0
    log(f"final loss after bench chain: {float(losses[-1][-1][-1]):.3f}")
    for g, ng in zip(sweep.groups, grids):
        g.state_grid = ng
    n_rows = sum(len(g.seeds) for g in sweep.groups)
    return (n_rows * chunk_steps * reps) / dt


def measure(trainer, chunk_steps: int = CHUNK_STEPS, reps: int = 10) -> float:
    """Time ``reps`` pre-compiled chunks back to back."""
    state = trainer.state
    state, losses = trainer.fns.train_chunk(state, chunk_steps)
    jax.block_until_ready(losses)  # warmup + compile
    t0 = time.perf_counter()
    for _ in range(reps):
        state, losses = trainer.fns.train_chunk(state, chunk_steps)
    jax.block_until_ready((state, losses))
    dt = time.perf_counter() - t0
    log(f"final loss after bench chain: {float(losses[-1]):.3f}")
    trainer.state = state
    return (chunk_steps * reps) / dt


def latency_mode(trainer, reps: int = 200):
    """Per-step dispatch latency: single-step chunks, each waited for.
    Percentiles to stderr."""
    import numpy as np

    state = trainer.state
    state, l = trainer.fns.train_chunk(state, 1)
    jax.block_until_ready(l)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state, l = trainer.fns.train_chunk(state, 1)
        jax.block_until_ready(l)
        times.append(time.perf_counter() - t0)
    trainer.state = state
    t = np.array(times) * 1e6
    log(f"per-step dispatch latency (us): p50={np.percentile(t,50):.0f} "
        f"p90={np.percentile(t,90):.0f} p99={np.percentile(t,99):.0f}")


# ---------------------------------------------------------------------------
# Analytic FLOPs / MFU accounting (the bench contract's compute denominator).
# Dense (no sparsity) peak rate, per device kind, of the unit a float32 dot
# runs on: --precision bf16 leaves f32 dots at XLA's default, which on
# Hopper runs them on the TF32 tensor cores; --precision fp32
# (Precision.HIGHEST) runs true FP32. Source: NVIDIA H100 Tensor Core GPU
# data sheet, SXM5 and PCIe columns (TF32 is quoted there with sparsity;
# the dense rate is half). Rates assume the card's full power limit.
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 494.5e12, "fp32": 67e12},  # SXM5
    "NVIDIA H100 PCIe": {"bf16": 378e12, "fp32": 51e12},
}


def device_peak_flops(kind: str, precision: str) -> float | None:
    """Peak FLOP/s of ``kind`` at ``precision``; None (and a log line) for
    a device kind the table does not know — never an assumed peak."""
    peak = PEAK_FLOPS.get(kind, {}).get(precision)
    if peak is None:
        log(f"no peak FLOP/s known for device kind {kind!r} at --precision "
            f"{precision}; mfu_pct is null")
    return peak


def mlp_step_flops(batch: int, data_dim: int, latent_dim: int,
                   enc_features, dec_features, dual: bool) -> int:
    """Analytic matmul FLOPs for ONE training step of the MLP VAE.

    Formula (matmul terms only): a Dense forward (B,k)·(k,n) costs 2·B·k·n
    FLOPs; the backward pass adds dX (2·B·k·n) and dW (2·B·k·n) at the same
    cost — training multiplier 3. The sigmoid dataset's dual decoder runs
    two decoder stacks. Elementwise work (reparam, ELBO, Adam) is excluded:
    the denominator counts matmul terms only, so ``mfu_pct`` reads as
    matrix-unit utilization — for the tiny elementwise-bound configs it is
    honestly low.
    """
    def net(in_dim, feats):
        fl, d = 0, in_dim
        for f in feats:
            fl += 2 * batch * d * f
            d = f
        return fl

    fwd = net(data_dim, enc_features)
    fwd += net(latent_dim, dec_features) * (2 if dual else 1)
    return 3 * fwd


def conv_step_flops(batch: int, image_hwc, latent_dim: int, channels) -> int:
    """Analytic matmul FLOPs for ONE training step of the conv VAE.

    Conv2D 3×3 stride 2 at output (B,Ho,Wo,Cout) costs 2·B·Ho·Wo·9·Cin·Cout;
    ConvTranspose 3×3 stride 2 costs 2·B·Hi·Wi·9·Cin·Cout (each input pixel
    feeds 9 taps). Dense layers as in mlp_step_flops. Training ×3.
    Mirrors models/conv.py: enc = [Conv(ch) for ch in channels] + Dense(mu);
    dec = Dense + [ConvTranspose] over reversed(channels) + UpOut.
    """
    h, w, c = image_hwc
    k2 = 9
    fwd = 0
    # encoder convs
    cin, hh, ww = c, h, w
    for ch in channels:
        hh, ww = hh // 2, ww // 2
        fwd += 2 * batch * hh * ww * k2 * cin * ch
        cin = ch
    fwd += 2 * batch * (hh * ww * cin) * latent_dim  # FCmu
    # decoder: Dense in, then transposed stack back up
    dec_ch = tuple(reversed(channels))
    n_up = len(dec_ch)
    h0, w0 = h // (2 ** n_up), w // (2 ** n_up)
    fwd += 2 * batch * latent_dim * (h0 * w0 * dec_ch[0])  # FCin
    cin, hh, ww = dec_ch[0], h0, w0
    for ch in dec_ch[1:]:
        fwd += 2 * batch * hh * ww * k2 * cin * ch
        cin, hh, ww = ch, hh * 2, ww * 2
    fwd += 2 * batch * hh * ww * k2 * cin * c  # UpOut
    return 3 * fwd


def workload_flops_per_step(config: str, obj) -> float:
    """FLOPs per MEASURED step of the benchmark workload. Grid configs
    count aggregate row-steps, so this is the average per row-step across
    the family's mixed-dimension rows."""
    if config in GRID_FAMILIES:
        total = rows = 0
        for g in obj.groups:
            m = g.model
            total += len(g.seeds) * mlp_step_flops(
                g.cfg.batch_size, g.data_dim, g.latent_dim,
                m.encoder_features, m.decoder_features,
                m.dual_sigmoid_decoder)
            rows += len(g.seeds)
        return total / rows
    if config == "conv":
        m = obj.model
        return conv_step_flops(obj.cfg.batch_size, m.image_hwc,
                               m.latent_dim, m.channels)
    m = obj.model
    return mlp_step_flops(obj.cfg.batch_size, obj.dataset.dimension,
                          m.latent_dim, m.encoder_features,
                          m.decoder_features, m.dual_sigmoid_decoder)


METRIC_NAMES = {
    "linear": "linear_vae_train_steps_per_sec",
    "sigmoid": "sigmoid_vae_train_steps_per_sec",
    "sphere": "sphere_mlp200_vae_train_steps_per_sec",
    "grid": "linear_sweep21_aggregate_steps_per_sec",
    "grid_linear": "linear_sweep21_aggregate_steps_per_sec",
    "grid_sigmoid": "sigmoid_sweep18_aggregate_steps_per_sec",
    "grid_sphere": "sphere_sweep15_aggregate_steps_per_sec",
    "conv": "conv_vae_train_steps_per_sec",
}

# sweep family per grid config ("grid" = the original alias)
GRID_FAMILIES = {"grid": "linear", "grid_linear": "linear",
                 "grid_sigmoid": "sigmoid", "grid_sphere": "sphere"}


def main(argv=None) -> int:
    import argparse

    from vae_training_tpu.runio import enable_compile_cache

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default="linear",
                   choices=["linear", "sigmoid", "sphere", "grid",
                            "grid_linear", "grid_sigmoid", "grid_sphere",
                            "conv"],
                   help="Workload to measure (grid_* = a whole sweep "
                        "family as per-row seed grids; 'grid' is an alias "
                        "for grid_linear).")
    p.add_argument("--latency", action="store_true",
                   help="Also report per-step dispatch latency percentiles "
                        "(stderr).")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"],
                   help="Matmul precision: bf16 (default: the backend's "
                        "default for f32 dots, TF32 on the H100) or fp32 "
                        "(Precision.HIGHEST true-fp32 dots).")
    p.add_argument("--adam_dtype", default="f32", choices=["f32", "bf16"],
                   help="Adam moment storage under test: f32 (default, "
                        "bitwise optax) or bf16 weight-matrix moments.")
    args = p.parse_args(argv)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench measures the GPU; JAX found platform {dev.platform!r}")
        return 1
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    enable_compile_cache()
    log(f"devices: {jax.devices()}")
    trainer = None
    if args.config in GRID_FAMILIES:
        measured = build_grid(args.precision, family=GRID_FAMILIES[args.config],
                              adam_dtype=args.adam_dtype)
        steps_per_sec = measure_grid(measured)
    elif args.config == "conv":
        measured, dataset = build_conv(args.precision)
        steps_per_sec = measure_conv(measured, dataset)
    else:
        measured = trainer = build(args.config, args.precision,
                                   args.adam_dtype)
        steps_per_sec = measure(trainer)
    log(f"steps/sec: {steps_per_sec:.0f}")
    # Compute denominator: analytic matmul FLOPs/step, and MFU against the
    # device's peak at the precision that ran (null for unknown kinds).
    flops_per_step = workload_flops_per_step(args.config, measured)
    peak = device_peak_flops(dev.device_kind, args.precision)
    mfu_pct = (round(100.0 * steps_per_sec * flops_per_step / peak, 4)
               if peak else None)
    log(f"flops/step: {flops_per_step:.4g}; "
        f"achieved: {steps_per_sec * flops_per_step / 1e12:.4f} TFLOP/s; "
        f"mfu: {mfu_pct}%")
    if args.latency:
        if trainer is not None:
            latency_mode(trainer)
        else:
            log("--latency applies to the linear/sigmoid/sphere configs "
                "only; skipped")
    print(json.dumps({
        "metric": METRIC_NAMES[args.config],
        "value": round(steps_per_sec, 1),
        "unit": "steps/sec",
        "flops_per_step": round(flops_per_step),
        "mfu_pct": mfu_pct,
        "precision": args.precision,
        "device": device,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
