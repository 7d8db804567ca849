#!/usr/bin/env python
"""End-to-end proof that the training path runs on one GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the multi-device phases

One process runs every phase (a JAX process reserves most of a card's
memory, so a second one could not share it). Phases, one card:

1. device — refuse anything but a GPU; print JAX version, device kind and
   count, nvidia-smi's name and power limit, and the optional packages
   present;
2. reference — for the linear, sigmoid, sphere and conv bench configs at
   full width: loss, gradients and the first Adam update of the package's
   compiled step on the GPU against ``vae_training_tpu.reference`` on the
   CPU (float32, Precision.HIGHEST), at --precision fp32 and at the
   default precision (TF32 dots);
3. solo run — ``run.main`` on sphere sweep row 1 (200|200|200, batch 100)
   for 10,001 steps (evals at 0/5000/10000, a plot event, a checkpoint),
   then an in-place resume for 1,000 more;
4. seed grid — ``--seed_grid 2,3,4`` on linear sweep row 1, 2,000 steps;
5. conv — the bench conv config in epoch mode, 2 epochs;
6. sample.py — ancestral samples from the phase-3 run directory.

Four cards: (a) a 4-seed grid sharded ``--mesh dp=4`` against the same
seeds on one card; (b) one sphere-width GSPMD step at dp=2,tp=2 against the
single-card step; (c) shard_map dp=4 against dp_dcn=2,dp=2.

Any failure raises (non-zero exit). The last stdout line is the JSON
verdict ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

# the CPU backend must stay available beside the GPU for the reference
if os.environ.get("JAX_PLATFORMS") and \
        "cpu" not in os.environ["JAX_PLATFORMS"].split(","):
    os.environ["JAX_PLATFORMS"] += ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from vae_training_tpu import reference  # noqa: E402
from vae_training_tpu._scripts import bench  # noqa: E402
from vae_training_tpu._scripts import run as run_mod  # noqa: E402
from vae_training_tpu._scripts import sample as sample_mod  # noqa: E402
from vae_training_tpu.config import RunConfig, parse_arguments  # noqa: E402
from vae_training_tpu.data import get_dataset  # noqa: E402
from vae_training_tpu.models import build_vae  # noqa: E402
from vae_training_tpu.models.conv import build_conv_vae  # noqa: E402
from vae_training_tpu.runio import enable_compile_cache  # noqa: E402
from vae_training_tpu.train.state import make_adam  # noqa: E402
from vae_training_tpu.train.step import make_elbo_grad_fn  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA_DIR = os.path.join(ROOT, "data")

# Phase-2 bounds (relative). fp32: both sides are true-fp32; they differ
# only in summation order over reductions up to 200 wide and in the GPU
# library's algorithm choice. Default precision: the GPU's dots run in
# TF32 (about 10 mantissa bits), so the loss gets a looser bound and the
# gradient/update errors are reported.
BOUNDS = {"fp32": {"loss": 1e-5, "grads": 1e-4, "update": 1e-4},
          "bf16": {"loss": 2e-2}}

# Sphere sweep row 1 (sphere_vae_padding_expts.sh, first run); the smoke
# trains 10,001 steps: evals at 0/5000/10000, plot + checkpoint at 0 and
# 10000.
SPHERE_ROW = ["chip_smoke_sphere", "--dataset", "sphere",
              "--encoder_layer_sizes", "200|200|200",
              "--layer_sizes", "200|200|200", "--latent_dim", "6",
              "--padding_dim", "3", "-dd", "3", "--epsilon", "-3", "-tdv"]


def say(*a):
    print(*a, flush=True)


class CompileLog:
    """Backend-compile seconds and persistent-cache hits/misses, from
    jax.monitoring events."""

    def __init__(self):
        self.compile_s = 0.0
        self.hits = self.misses = 0
        jax.monitoring.register_event_duration_secs_listener(self._duration)
        jax.monitoring.register_event_listener(self._event)

    def _duration(self, name, secs, **_):
        if name == "/jax/core/compile/backend_compile_duration":
            self.compile_s += secs

    def _event(self, name, **_):
        if name == "/jax/compilation_cache/cache_hits":
            self.hits += 1
        elif name == "/jax/compilation_cache/cache_misses":
            self.misses += 1


def peak_bytes() -> int:
    return jax.devices()[0].memory_stats()["peak_bytes_in_use"]


def phase_device(cards: int) -> dict:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found platform "
                         f"{dev.platform!r} ({dev.device_kind})")
    if len(jax.devices()) < cards:
        raise SystemExit(f"--cards {cards} needs {cards} GPUs; JAX found "
                         f"{len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    optional = {m: importlib.util.find_spec(m) is not None
                for m in ("flax", "matplotlib", "tqdm")}
    say(f"[device] jax {jax.__version__}; {dev.device_kind} x "
        f"{len(jax.devices())}")
    say(f"[device] nvidia-smi: {smi}")
    say(f"[device] optional packages importable: {optional}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": cards}


def _model_and_batch(config: str, precision: str):
    """The bench config's model, its params, and one batch + noise, all
    as host arrays (made on the CPU from fixed seeds)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        if config == "conv":
            cfg = bench.make_conv_cfg(precision)
            dataset = get_dataset(cfg.dataset, 0, cfg)
            model = build_conv_vae(
                image_hwc=tuple(dataset.shape),
                latent_dim=cfg.latent_dimension,
                channels_spec=cfg.conv_channels, epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var,
                precision=precision)
            spec = reference.Spec(cfg.epsilon, cfg.tunable_decoder_var,
                                  image_hwc=tuple(dataset.shape))
        else:
            cfg = bench.make_cfg(config, precision)
            dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
            model = build_vae(
                data_dim=dataset.dimension, latent_dim=cfg.latent_dimension,
                encoder_layer_sizes=cfg.encoder_layer_sizes,
                decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var,
                dataset_name=cfg.dataset, precision=precision)
            spec = reference.Spec(cfg.epsilon, cfg.tunable_decoder_var,
                                  dual=cfg.dataset == "sigmoid")
        x = np.asarray(dataset.sample(jax.random.PRNGKey(1), cfg.batch_size))
        params = jax.device_get(
            jax.jit(model.init)(jax.random.PRNGKey(0), x[:1])["params"])
    rng = np.random.RandomState(0)
    z1 = rng.randn(x.shape[0], model.latent_dim).astype(np.float32)
    z2 = rng.randn(*x.shape).astype(np.float32)
    return cfg, model, spec, params, (x, z1, z2)


def phase_reference() -> None:
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    failures = []
    for config in ("linear", "sigmoid", "sphere", "conv"):
        for precision in ("fp32", "bf16"):
            cfg, model, spec, params, batch = _model_and_batch(config,
                                                               precision)
            lr = cfg.learning_rate
            tx = make_adam(lr)
            grad_fn = jax.jit(make_elbo_grad_fn(model))

            @jax.jit
            def adam_step(p, g):
                updates, _ = tx.update(g, tx.init(p), p)
                return optax.apply_updates(p, updates)

            p_gpu, b_gpu = jax.device_put((params, batch), gpu)
            loss, grads = grad_fn(p_gpu, *b_gpu)
            new = adam_step(p_gpu, grads)
            p_cpu, b_cpu = jax.device_put((params, batch), cpu)
            ref_loss, ref_grads, ref_new = jax.jit(
                lambda p, x, z1, z2: reference.step(spec, p, x, z1, z2, lr)
            )(p_cpu, *b_cpu)
            delta = jax.tree_util.tree_map(lambda a, b: a - b,
                                           jax.device_get(new), params)
            ref_delta = jax.tree_util.tree_map(
                lambda a, b: a - b, jax.device_get(ref_new), params)
            errs = {
                "loss": abs(float(loss) - float(ref_loss))
                / abs(float(ref_loss)),
                "grads": reference.rel_err(jax.device_get(grads),
                                           jax.device_get(ref_grads)),
                "update": reference.rel_err(delta, ref_delta),
            }
            parts = []
            for k, e in errs.items():
                bound = BOUNDS[precision].get(k)
                parts.append(f"{k} {e:.3e} (bound {bound if bound else '-'})")
                if bound is not None and not e <= bound:
                    failures.append(f"{config}/{precision} {k} {e:.3e}")
            say(f"[reference] {config:7s} --precision {precision}: "
                f"loss {float(loss):.6f} vs {float(ref_loss):.6f}; "
                + "; ".join(parts))
    if failures:
        raise AssertionError(f"reference mismatch: {failures}")


def _run_main(argv, *, data_dir=DATA_DIR, **overrides) -> str:
    """run.main on parsed CLI flags; returns its console output (echoed)."""
    cfg = parse_arguments(argv)
    cfg.data_dir = data_dir
    cfg.tqdm = False
    for k, v in overrides.items():
        setattr(cfg, k, v)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = run_mod.main(cfg)
    sys.stdout.write(out.getvalue())
    assert rc == 0, f"run.main returned {rc}"
    return out.getvalue()


def _train_losses(run_dir: str) -> np.ndarray:
    z = np.load(os.path.join(run_dir, "losses.npz"), allow_pickle=True)
    losses = np.asarray(z["VAE Loss"], np.float64)
    assert losses.size and np.all(np.isfinite(losses)), run_dir
    return losses


def phase_solo(clog: CompileLog) -> str:
    c0, t0 = clog.compile_s, time.perf_counter()
    out = _run_main(SPHERE_ROW + ["-ow", "--num_batches", "10001"])
    wall = time.perf_counter() - t0
    run_dir = os.path.join(DATA_DIR, SPHERE_ROW[0])
    rates = [float(line.rsplit("|", 1)[1]) for line in out.splitlines()
             if line.startswith("Batch | 10000 |") and "steps/sec" in line]
    losses = _train_losses(run_dir)
    assert losses[-500:].mean() < losses[0], (losses[0], losses[-500:].mean())
    for f in ("args.json", "losses.npz", "model.pkl", "ckpt.npz",
              "ckpt_meta.json"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    say(f"[solo] sphere row 1, 10001 steps in {wall:.1f}s; steps/sec after "
        f"compile (steps 5000-10000): {rates[0] if rates else 'n/a'}; "
        f"backend compile {clog.compile_s - c0:.2f}s; peak device bytes "
        f"{peak_bytes()}; loss {losses[0]:.3f} -> {losses[-500:].mean():.3f}")

    _run_main(SPHERE_ROW + ["--num_batches", "11001", "--resume", run_dir])
    with open(os.path.join(run_dir, "ckpt_meta.json")) as f:
        step = json.load(f)["step"]
    assert step == 11001, step
    resumed = _train_losses(run_dir)
    assert resumed.size > losses.size
    say(f"[solo] in-place resume to step {step}: loss "
        f"{resumed[-500:].mean():.3f}")
    return run_dir


def phase_grid() -> None:
    lin = bench.CONFIGS["linear"]
    argv = ["chip_smoke_grid", "--dataset", "linear_gaussian",
            "--encoder_layer_sizes", "", "--layer_sizes", "", "-ow",
            "--latent_dim", str(lin["latent_dimension"]),
            "--padding_dim", str(lin["padding_dim"]),
            "-dd", str(lin["dataset_dimension"]), "--num_batches", "2000",
            "--epsilon", "-1", "-tdv", "-lr", "1e-3",
            "--seed_grid", "2,3,4"]
    t0 = time.perf_counter()
    _run_main(argv)
    for seed in (2, 3, 4):
        losses = _train_losses(
            os.path.join(DATA_DIR, f"chip_smoke_grid_seed{seed}"))
        assert losses[-100:].mean() < losses[0], seed
    say(f"[grid] linear row 1, seeds 2,3,4, 2000 steps in "
        f"{time.perf_counter() - t0:.1f}s; per-seed outputs written")


def phase_conv() -> None:
    cfg = bench.make_conv_cfg()
    cfg.name, cfg.num_epochs, cfg.overwrite = "chip_smoke_conv", 2, True
    cfg.data_dir = DATA_DIR
    t0 = time.perf_counter()
    assert run_mod.main(cfg) == 0
    run_dir = os.path.join(DATA_DIR, cfg.name)
    z = np.load(os.path.join(run_dir, "losses.npz"), allow_pickle=True)
    evals = np.asarray(z["Encoder Variance"])  # one entry per eval
    losses = _train_losses(run_dir)
    n_batches = cfg.num_images // cfg.batch_size
    first, last = losses[1:1 + n_batches].mean(), losses[-1 - n_batches:-1].mean()
    assert last < first, (first, last)
    say(f"[conv] 2 epochs of {n_batches} batches in "
        f"{time.perf_counter() - t0:.1f}s; {len(evals)} evals; mean train "
        f"loss epoch 0 {first:.2f} -> epoch 1 {last:.2f}")


def phase_sample(run_dir: str) -> None:
    out = os.path.join(DATA_DIR, "chip_smoke_samples.npz")
    assert sample_mod.main([run_dir, "-n", "512", "-o", out]) == 0
    z = np.load(out)
    assert z["samples"].shape == (512, 6), z["samples"].shape
    assert np.all(np.isfinite(z["samples"]))
    say(f"[sample] {z['samples'].shape} samples, latents "
        f"{z['latents'].shape}")


# ---------------------------------------------------------------------------
# four cards


def phase_grid_sharded() -> None:
    from vae_training_tpu.train.grid import GridTrainer

    seeds = [2, 3, 4, 5]
    cfg = bench.make_cfg("linear")
    cfg.overwrite, cfg.data_dir = True, DATA_DIR

    def losses_of(mesh):
        trainer = GridTrainer(RunConfig(**{**cfg.to_json_dict(),
                                           "mesh": mesh}), seeds)
        _, losses = trainer._train_chunk(trainer.dataset_grid,
                                         trainer.state_grid, 500)
        return np.asarray(losses)

    sharded, single = losses_of("dp=4"), losses_of("")
    assert np.all(np.isfinite(sharded))
    diff = np.abs(sharded - single).max() / np.abs(single).max()
    say(f"[4-card grid] 4 linear seeds x 500 steps, dp=4 vs one card: "
        f"max rel loss diff {diff:.3e} (bitwise equal: "
        f"{np.array_equal(sharded, single)}; bound 1e-4)")
    assert diff <= 1e-4


def _sphere_setup():
    cfg = bench.make_cfg("sphere", "fp32")
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    model = build_vae(
        data_dim=dataset.dimension, latent_dim=cfg.latent_dimension,
        encoder_layer_sizes=cfg.encoder_layer_sizes,
        decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
        tunable_decoder_var=True, dataset_name="sphere", precision="fp32")
    tx = make_adam(cfg.learning_rate)
    from vae_training_tpu.train import TrainState

    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, dataset.dimension)))["params"]
    state = TrainState.create(params=params, tx=tx,
                              model_key=jax.random.PRNGKey(1),
                              data_key=jax.random.PRNGKey(2))
    return cfg, dataset, model, tx, jax.device_get(state)


def phase_gspmd() -> None:
    from vae_training_tpu.parallel import make_gspmd_step_fns, make_mesh
    from vae_training_tpu.train import make_step_fns

    cfg, dataset, model, tx, state = _sphere_setup()
    single = make_step_fns(model, dataset, tx, cfg.batch_size)
    s1, l1 = single.train_chunk(jax.device_put(state, jax.devices()[0]), 1)
    fns = make_gspmd_step_fns(model, dataset, tx, cfg.batch_size,
                              make_mesh("dp=2,tp=2"))
    s2, l2 = fns.train_chunk(fns.place_state(state), 1)
    loss_err = abs(float(l2[0]) - float(l1[0])) / abs(float(l1[0]))
    param_err = reference.rel_err(jax.device_get(s2.params),
                                  jax.device_get(s1.params))
    say(f"[4-card gspmd] sphere 200^3 step at dp=2,tp=2 vs one card "
        f"(fp32): loss rel err {loss_err:.3e} (bound 1e-5), params rel err "
        f"{param_err:.3e} (bound 1e-4)")
    assert loss_err <= 1e-5 and param_err <= 1e-4


def phase_dp_two_level() -> None:
    from vae_training_tpu.parallel import make_dp_step_fns, make_mesh

    cfg, dataset, model, tx, state = _sphere_setup()
    out = {}
    for spec in ("dp=4", "dp_dcn=2,dp=2"):
        fns = make_dp_step_fns(model, dataset, tx, cfg.batch_size,
                               make_mesh(spec))
        s, losses = fns.train_chunk(fns.place_state(state), 300)
        out[spec] = (np.asarray(losses), jax.device_get(s.params))
    (l1, p1), (l2, p2) = out["dp=4"], out["dp_dcn=2,dp=2"]
    loss_diff = np.abs(l1 - l2).max() / np.abs(l1).max()
    param_err = reference.rel_err(p2, p1)
    say(f"[4-card dp] sphere 300 steps, dp=4 vs dp_dcn=2,dp=2: max rel "
        f"loss diff {loss_diff:.3e} (bound 1e-5), params rel err "
        f"{param_err:.3e} (bound 1e-4)")
    assert np.all(np.isfinite(l1)) and loss_diff <= 1e-5 \
        and param_err <= 1e-4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=[1, 4],
                   help="4: run only the multi-device phases on 4 GPUs.")
    args = p.parse_args(argv)
    device = phase_device(args.cards)
    enable_compile_cache()
    clog = CompileLog()
    t0 = time.perf_counter()
    if args.cards == 4:
        phase_grid_sharded()
        phase_gspmd()
        phase_dp_two_level()
    else:
        phase_reference()
        run_dir = phase_solo(clog)
        phase_grid()
        phase_conv()
        phase_sample(run_dir)
    say(f"[summary] {time.perf_counter() - t0:.1f}s; backend compile "
        f"{clog.compile_s:.1f}s; persistent cache hits {clog.hits}, misses "
        f"{clog.misses}; peak device bytes {peak_bytes()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
