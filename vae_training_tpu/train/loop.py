"""The training engine: chunked compiled training with host-side cadences.

Re-architecture of the reference's ``Model``/``GenerativeModel`` engine
(reference/model.py:18-255). Behavioral contract preserved:

  - stat line every ``n_print`` = 5000 steps, plot+save every ``n_plot`` =
    50000 steps and at the last step, eval batch size 1000
    (reference/model.py:123-126);
  - events fire BEFORE that step's gradient update (the batch-0 eval sees
    the freshly initialized model — reference/model.py:213-222);
  - "Score for real data" console line at train start
    (reference/model.py:209-211);
  - per-step training losses recorded (→ the npz "VAE Loss" trace).

Architecture inverted for an accelerator: between events the engine runs
ONE compiled scan chunk covering every intervening step (5k steps per
device program instead of 5k Python dispatches). Eval, plotting, and saving are the only
host work.
"""

from __future__ import annotations

import os
import time
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import RunConfig
from ..data.base import DistributionDataset
from ..models.networks import build_vae
from ..models.warm_start import apply_warm_start
from ..evals.stats import StatsRecorder
from ..runio.background import get_artifact_writer
from ..runio.checkpoint import (
    restore_checkpoint,
    restore_checkpoint_aux,
    save_checkpoint,
    save_checkpoint_async,
)
from ..runio.export import load_model_pkl, save_model_pkl
from ..utils.process import is_primary
from ..utils.trees import correlation_ratio, correlation_ratio_per_param
from .state import TrainState, make_adam
from .step import make_step_fns, sample_z, split_z

N_PLOT = 50000
N_PRINT = 5000
EVAL_BATCH_SIZE = 1000


def next_event(b: int, total: int, n_print: int, n_plot: int) -> int:
    """First step index > b at which any host event fires.

    THE chunk-boundary formula, shared by the solo and grid trainers, so
    their host events (evals, plots, saves) land on the same steps — keep
    one definition."""
    nxt = ((b // n_print) + 1) * n_print
    nxt = min(nxt, ((b // n_plot) + 1) * n_plot)
    if b < total - 1:
        nxt = min(nxt, total - 1)
    return min(nxt, total)


class Trainer:
    """Owns model/optimizer/state and drives the chunked training loop."""

    def __init__(
        self,
        cfg: RunConfig,
        dataset: DistributionDataset,
        output_dir: str,
        track_correlation: Optional[bool] = None,
    ):
        self.cfg = cfg
        self.dataset = dataset
        self.dirname = output_dir
        self.n_plot = getattr(cfg, "n_plot", N_PLOT) or N_PLOT
        self.n_print = getattr(cfg, "n_print", N_PRINT) or N_PRINT
        self.eval_batch_size = EVAL_BATCH_SIZE
        if track_correlation is None:
            track_correlation = getattr(cfg, "track_correlation", False)
        self.track_correlation = track_correlation

        data_dim = dataset.dimension
        self.latent_dim = cfg.latent_dimension
        arch = cfg.arch
        if arch == "auto":
            arch = "conv" if dataset.is_epochs else "mlp"
        if arch == "conv":
            if len(dataset.shape) != 3:
                raise ValueError(
                    "--arch conv requires an image dataset (H, W, C); "
                    f"--dataset {cfg.dataset} has shape {tuple(dataset.shape)}"
                )
            from ..models.conv import build_conv_vae

            self.model = build_conv_vae(
                image_hwc=tuple(dataset.shape),
                latent_dim=cfg.latent_dimension,
                channels_spec=cfg.conv_channels,
                epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var,
                precision=cfg.precision,
            )
        else:
            self.model = build_vae(
                data_dim=data_dim,
                latent_dim=cfg.latent_dimension,
                encoder_layer_sizes=cfg.encoder_layer_sizes,
                decoder_layer_sizes=cfg.layer_sizes,
                epsilon=cfg.epsilon,
                tunable_decoder_var=cfg.tunable_decoder_var,
                dataset_name=cfg.dataset,
                precision=cfg.precision,
            )

        # Host-side key chain, seeded like the reference's fixed PRNGKey(0)
        # (reference/model.py:29) but configurable via --model_seed.
        self.key = jax.random.PRNGKey(cfg.model_seed)
        vae_key, self.key = jax.random.split(self.key)
        dummy_x = jnp.zeros((1, data_dim))
        dummy_z1 = jnp.zeros((1, self.latent_dim))
        dummy_z2 = jnp.zeros((1, data_dim))
        # jitted: one compiled program instead of dozens of eagerly
        # dispatched init ops
        variables = jax.jit(self.model.init)(
            vae_key, dummy_x, dummy_z1, dummy_z2)
        params = variables["params"]

        if cfg.warm_start:
            ws_key, self.key = jax.random.split(self.key)
            params = apply_warm_start(
                dict(params),
                cfg.dataset,
                dataset,
                self.latent_dim,
                cfg.latent_off_dimension,
                ws_key,
            )

        # Adam with the reference's defaults (flax.optim.Adam: b1=0.9,
        # b2=0.999, eps=1e-8 — reference/vae.py:113). make_adam is the
        # single source of truth shared with the grid trainer.
        self.tx = make_adam(cfg.learning_rate,
                            getattr(cfg, "adam_dtype", "f32"))

        z_base_key, self.key = jax.random.split(self.key)
        data_root = jax.random.PRNGKey(cfg.dataset_seed)
        train_data_key = jax.random.fold_in(data_root, 1)
        self._eval_data_root = jax.random.fold_in(data_root, 2)
        self._eval_counter = 0

        self.state = TrainState.create(
            params=params,
            tx=self.tx,
            model_key=z_base_key,
            data_key=train_data_key,
        )

        self.fns = self._build_step_fns()
        if self.fns.place_state is not None:
            self.state = self.fns.place_state(self.state)
        if dataset.is_epochs:
            from .step import make_epoch_chunk

            mesh = None
            if cfg.mesh:
                # dp-only already validated in _build_step_fns (which runs
                # first and rejects tp for epoch datasets)
                from ..parallel.mesh import make_mesh

                mesh = make_mesh(
                    cfg.mesh,
                    allow_uneven=getattr(cfg, "mesh_allow_uneven", False))
            self.epoch_chunk = make_epoch_chunk(
                self.model, dataset, self.tx, cfg.batch_size, mesh=mesh
            )
        self.epoch_num = 0

        self.recorder = StatsRecorder()
        self.epsilon = cfg.epsilon
        self.current_epsilon = cfg.epsilon
        self.batchnum = 0
        self.params_and_gradients = []
        # Resume bookkeeping: _resumed_with_aux ⇒ the host-side run state
        # (recorder, eval counter, key chain) was restored, so start-of-run
        # key consumers (the "Score for real data" banner / epoch-0 eval)
        # must not fire again; _skip_events_at marks a step whose print/plot
        # events already fired before the checkpoint was written.
        self._resumed_with_aux = False
        self._skip_events_at = -1

        # Resume paths: full checkpoint (--resume) or reference-layout
        # model.pkl (--state_dict, made real — SURVEY.md §3.5).
        if cfg.resume:
            from ..runio.checkpoint import checkpoint_exists
            from ..utils.process import check_shared_fs

            check_shared_fs(checkpoint_exists(cfg.resume), cfg.resume)
            self.state = restore_checkpoint(cfg.resume, self.state)
            if self.fns.place_state is not None:
                # restored leaves are host arrays; re-shard onto the mesh
                self.state = self.fns.place_state(self.state)
            self.batchnum = int(self.state.step)
            aux = restore_checkpoint_aux(cfg.resume)
            if aux is not None and aux.get("step", self.batchnum) != self.batchnum:
                # a kill between the ckpt and aux replaces left stale host
                # state next to a newer TrainState: degrade to a state-only
                # resume (training stream stays bit-exact; stat history and
                # eval streams restart) rather than silently mixing epochs
                print(f"[resume] checkpoint aux is from step "
                      f"{aux['step']}, state is at {self.batchnum}; "
                      f"resuming without host-side history", flush=True)
                aux = None
            if aux is not None and "eval_counter" in aux:
                # full solo aux: exact continuation of the host-side streams
                self.recorder = StatsRecorder.from_state(aux["recorder"])
                self._eval_counter = int(aux["eval_counter"])
                self.key = jnp.asarray(aux["host_key"])
                self.epoch_num = int(aux.get("epoch_num", 0))
                self.params_and_gradients = list(
                    aux.get("params_and_gradients", []))
                self._resumed_with_aux = True
                if aux.get("events_fired_at_step", False):
                    self._skip_events_at = self.batchnum
            elif aux is not None and "recorder" in aux:
                # a GRID row's aux (written by GridTrainer.save_all): carry
                # the stat history over, but keep fresh solo eval streams —
                # the grid's eval keys derive from its own shared chain
                self.recorder = StatsRecorder.from_state(aux["recorder"])
                if aux.get("events_fired_at_step", False):
                    self._skip_events_at = self.batchnum
            # restore the learned decoder log-variance used for generation
            # (host-side state alongside the device TrainState)
            import json as _json

            meta_path = os.path.join(cfg.resume, "ckpt_meta.json")
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    meta = _json.load(f)
                if "current_epsilon" in meta:
                    self.current_epsilon = meta["current_epsilon"]
        elif cfg.state_dict:
            from ..utils.process import check_shared_fs

            check_shared_fs(os.path.exists(cfg.state_dict), cfg.state_dict,
                            what="state dict")
            params, opt_state = load_model_pkl(
                cfg.state_dict, self.state.params, self.state.opt_state
            )
            self.state = self.state.replace(params=params, opt_state=opt_state)

    # ------------------------------------------------------------------
    def _build_step_fns(self):
        if self.cfg.mesh:
            if self.dataset.is_epochs:
                from ..parallel.mesh import parse_mesh_spec

                if parse_mesh_spec(self.cfg.mesh).get("tp", 1) > 1:
                    raise ValueError(
                        "epoch-mode (image) training shards the batch over "
                        "dp; use a pure dp spec (e.g. --mesh dp=8)"
                    )
            from ..parallel.api import make_parallel_step_fns

            return make_parallel_step_fns(
                self.model,
                self.dataset,
                self.tx,
                self.cfg.batch_size,
                mesh_spec=self.cfg.mesh,
                allow_uneven=getattr(self.cfg, "mesh_allow_uneven", False),
                tp_allow_replicated=getattr(
                    self.cfg, "tp_allow_replicated", False),
            )
        return make_step_fns(
            self.model, self.dataset, self.tx, self.cfg.batch_size
        )

    # ------------------------------------------------------------------
    @property
    def params(self):
        return self.state.params

    def get_key(self) -> jax.Array:
        self.key, key = jax.random.split(self.key)
        return key

    def _next_eval_data_key(self) -> jax.Array:
        self._eval_counter += 1
        return jax.random.fold_in(self._eval_data_root, self._eval_counter)

    def sample_latent(self, key: jax.Array, batch_size: int) -> jax.Array:
        """Prior draw. Gaussian: (batch, latent_dim + data_dim) = z1 ⊕ z2.
        Logistic: (batch, latent_dim), resampled until finite.

        Reference: reference/model.py:225-236.
        """
        dist = self.cfg.latent_distribution
        if dist == "gaussian":
            return sample_z(key, batch_size, self.latent_dim, self.dataset.dimension)
        if dist == "logistic":
            while True:
                key, tmp = jax.random.split(key)
                sample = jax.random.logistic(tmp, (batch_size, self.latent_dim))
                if bool(jnp.isfinite(sample).all()):
                    return sample
        raise NotImplementedError(f"distribution {dist} is not implemented")

    def latent_likelihood(self, latent_batch: jax.Array) -> jax.Array:
        """Mean prior log-likelihood of a latent batch.

        Reference: reference/model.py:238-244.
        """
        from jax.scipy.stats import logistic, norm

        dist = self.cfg.latent_distribution
        if dist == "gaussian":
            return jnp.mean(jnp.sum(norm.logpdf(latent_batch), axis=1), axis=0)
        if dist == "logistic":
            return jnp.mean(jnp.sum(logistic.logpdf(latent_batch), axis=1), axis=0)
        raise NotImplementedError(f"distribution {dist} is not implemented")

    def sample_batch(
        self, key: jax.Array, batch_size: int, latents: Optional[jax.Array] = None
    ) -> Tuple[jax.Array, jax.Array]:
        """Ancestral sampling with the current decoder log-variance.

        Reference: reference/vae.py:191-201 (minus its re-jit-per-call
        bug — our generate fn is compiled once).
        """
        z = latents if latents is not None else self.sample_latent(key, batch_size)
        z1, z2 = split_z(z, self.latent_dim)
        x_hat = self.fns.generate(
            self.state.params, z1, z2, jnp.asarray(self.current_epsilon)
        )
        return x_hat, z

    # ------------------------------------------------------------------
    def compute_stats(self) -> dict:
        """Eval pass: model ELBO components on real data + analytic manifold
        scores on generated data. Reference: reference/model.py:153-168
        + reference/vae.py:132-141.

        The whole eval (real-batch sample, generation, ELBO decomposition,
        analytic scoring) runs as ONE compiled program (fns.eval_step) with a
        single host transfer — the reference dispatches ~6 device programs
        and syncs after each.
        """
        key = self.get_key()
        eval_data_key = self._next_eval_data_key()
        if self.fns.eval_step is not None and not self.track_correlation:
            eps_scalar = jnp.float32(
                np.asarray(self.current_epsilon).reshape(-1)[0]
            )
            out = jax.device_get(
                self.fns.eval_step(
                    self.state.params, eval_data_key, key, eps_scalar,
                    n=self.eval_batch_size,
                )
            )
            logvar_e = out.pop("_logvar_e")
            epsilon = out.pop("_epsilon")
            fake = out.pop("_fake", None)
            self.recorder.append_eval(out["VAE Loss"], logvar_e, epsilon)
            self.current_epsilon = epsilon
            # jit returns dicts with sorted keys; restore the reference's
            # console ordering (model stats first, then dataset scores).
            stats = {k: out.pop(k) for k in ("VAE Loss", "KL divergence", "mse")}
            stats.update(out)
            if fake is not None:
                stats.update(self.dataset.score_host(np.asarray(fake)))
            return stats
        real_batch = self.dataset.sample(eval_data_key, self.eval_batch_size)
        fake_batch, latents = self.sample_batch(key, self.eval_batch_size)
        z1, z2 = split_z(latents, self.latent_dim)
        loss, dkl, mse, logvar_e, epsilon = self.fns.eval_loss(
            self.state.params, real_batch, z1, z2
        )
        self.recorder.append_eval(loss, logvar_e, epsilon)
        self.current_epsilon = epsilon
        stats = {"VAE Loss": loss, "KL divergence": dkl, "mse": mse}
        if getattr(self.dataset, "score_on_host", False):
            score = self.dataset.score_host(np.asarray(fake_batch))
        else:
            score = jax.device_get(self.fns.score(fake_batch))
        if not isinstance(score, dict):
            stats["Average Log Likelihood"] = score
            self.recorder.average_log_likelihoods.append(score)
        else:
            stats.update(score)
        if self.track_correlation:
            _, grads = self.fns.loss_and_grads(self.state.params, real_batch, z1, z2)
            self.params_and_gradients.append(
                (jax.device_get(self.state.params), jax.device_get(grads))
            )
        return stats

    def write_stats(self, stats: dict, console_only: Optional[dict] = None) -> None:
        is_epochs = self.dataset.is_epochs
        num = self.epoch_num if is_epochs else self.batchnum
        message = self.recorder.write_stats(
            num, stats, is_epochs=is_epochs, console_only=console_only
        )
        if is_primary():  # every process records; only process 0 speaks
            print(message, flush=True)

    def plot_model_specific(self):
        pass

    def plot(self):
        self.plot_model_specific()

    def plot_epoch(self) -> None:
        # the device sampling is collective (all processes participate);
        # the figure write is process 0's
        key = self.get_key()
        batch = np.asarray(self.sample_batch(key, self.eval_batch_size)[0])
        if not is_primary():
            return
        # epoch datasets index plots by epoch (reference/model.py:142-145)
        tag = self.epoch_num if self.dataset.is_epochs else self.batchnum
        fn = os.path.join(self.dirname, f"output_{tag}.png")
        # host IO off the training timeline (epoch mode writes a figure
        # EVERY epoch — ~140 ms of matplotlib against ~ms of device compute);
        # `batch` is host data, and the single writer thread owns pyplot
        get_artifact_writer().submit(
            partial(self.dataset.plot_batch, batch, fn=fn))

    # ------------------------------------------------------------------
    def _next_event(self, b: int) -> int:
        return next_event(b, self.cfg.num_batches, self.n_print, self.n_plot)

    def train(self) -> None:
        try:
            if self.dataset.is_epochs:
                self.train_epochs()
            else:
                self.train_distribution()
        except BaseException:
            # flush queued plot/save IO (the newest durable checkpoint a
            # retry resumes from) without masking the training error
            get_artifact_writer().drain_quietly()
            raise
        # train() returned ⇒ every in-loop artifact is on disk
        get_artifact_writer().drain()

    def train_epochs(self) -> None:
        """Epoch-mode loop: each epoch is ONE compiled device program.

        Cadence mirrors reference/model.py:176-193: stats before
        training, then per epoch train-all-batches → stats → plot → save.
        """
        n_batches = self.dataset.n // self.cfg.batch_size
        if n_batches == 0:
            raise ValueError("batch_size exceeds the dataset size")
        # Resume-aware: a restored state at step S has completed S//n_batches
        # epochs; continue from there (the per-epoch shuffle key is
        # fold_in(data_key, epoch), so no permutation is replayed).
        start_epoch = int(self.state.step) // n_batches
        self.batchnum = int(self.state.step)
        if not self._resumed_with_aux:
            # before-training eval (reference/model.py:177-178); a
            # full-state resume already has it in its restored history
            self.write_stats(self.compute_stats())
        progress = None
        if self.cfg.tqdm and is_primary():
            try:
                from tqdm import trange

                progress = trange(start_epoch, self.cfg.num_epochs)
            except Exception:
                progress = None
        epochs = (progress if progress is not None
                  else range(start_epoch, self.cfg.num_epochs))
        for self.epoch_num in epochs:
            self.state, losses = self.epoch_chunk(
                self.state, jnp.asarray(self.epoch_num), n_batches
            )
            self.recorder.append_train_losses(jax.device_get(losses))
            self.batchnum += n_batches
            stats = self.compute_stats()
            if is_primary():
                print(f"Completed Epoch {self.epoch_num}", flush=True)
            self.write_stats(stats)
            self.plot_epoch()
            self.save()

    def train_distribution(self) -> None:
        if not self._resumed_with_aux:
            # start-of-run banner (reference/model.py:209-211); a run
            # resumed with full host state already consumed this eval key
            eval_batch = self.dataset.sample(
                self._next_eval_data_key(), self.eval_batch_size
            )
            if getattr(self.dataset, "score_on_host", False):
                score = self.dataset.score_host(np.asarray(eval_batch))
            else:
                score = jax.device_get(self.fns.score(eval_batch))
            if is_primary():
                print(f"Score for real data: {score}", flush=True)

        total = self.cfg.num_batches
        progress = None
        if self.cfg.tqdm and is_primary():
            try:
                from tqdm import tqdm as _tqdm

                progress = _tqdm(total=total, initial=self.batchnum)
            except Exception:
                progress = None

        profiled = False
        b = self.batchnum
        last_rate_steps, last_rate_time = b, time.perf_counter()
        while b < total:
            self.batchnum = b
            if b % self.n_print == 0 and b != self._skip_events_at:
                stats = self.compute_stats()
                console_only = None
                now = time.perf_counter()
                if b > last_rate_steps and now > last_rate_time:
                    # wall-clock training rate since the previous stat event
                    # (console-only: non-deterministic, not an npz channel)
                    console_only = {"steps/sec": (b - last_rate_steps) / (
                        now - last_rate_time
                    )}
                last_rate_steps, last_rate_time = b, now
                self.write_stats(stats, console_only=console_only)
            if (b % self.n_plot == 0 or b == total - 1) and b != self._skip_events_at:
                self.plot_epoch()
                self.save()
            n = self._next_event(b) - b
            if self.cfg.nojit:
                # interpreted mode unrolls scans in Python — keep chunks
                # small so -nojit stays a usable step-through debugger
                n = min(n, 20)
            if self.cfg.profile and not profiled and n > 1:
                jax.profiler.start_trace(os.path.join(self.dirname, "profile"))
            self.state, losses = self.fns.train_chunk(self.state, n)
            if self.cfg.profile and not profiled and n > 1:
                jax.block_until_ready(losses)
                jax.profiler.stop_trace()
                profiled = True
            self.recorder.append_train_losses(jax.device_get(losses))
            if (
                self.cfg.checkpoint_every and is_primary()
                and (b + n) // self.cfg.checkpoint_every > b // self.cfg.checkpoint_every
            ):
                # async: snapshot now, write on a background thread — the
                # preemption-resilience path must not stall training
                save_checkpoint_async(
                    self.dirname, self.state,
                    extra_meta={"current_epsilon": float(
                        np.asarray(self.current_epsilon).reshape(-1)[0])},
                    backend=getattr(self.cfg, "ckpt_backend", "npz"),
                    # async saves land between chunks — events at this step
                    # have NOT fired yet; a resume must fire them
                    aux=self._snapshot_aux(events_fired_at_step=False),
                )
            b += n
            if progress is not None:
                progress.update(n)
        self.batchnum = max(total - 1, 0)
        if progress is not None:
            progress.close()

    # ------------------------------------------------------------------
    def _snapshot_aux(self, events_fired_at_step: bool) -> dict:
        """Host snapshot of everything a bit-exact resume needs beyond the
        TrainState: the stat history (→ identical losses.npz), the eval-key
        counter and host key chain (→ identical eval random streams), and
        whether this step's print/plot events already ran (sync saves fire
        after the events; async --checkpoint_every saves fire between
        chunks, before them)."""
        return {
            "recorder": self.recorder.to_state(),
            "eval_counter": self._eval_counter,
            "host_key": np.asarray(self.key),
            "epoch_num": self.epoch_num if hasattr(self, "epoch_num") else 0,
            # only populated under --track_correlation: a (params, grads)
            # tree per eval. Each save re-pickles the whole history —
            # O(evals × model size) per write — accepted so a resumed
            # diagnostic run's final correlation ratios match an
            # uninterrupted run's; the default path carries an empty list.
            "params_and_gradients": list(self.params_and_gradients),
            "events_fired_at_step": events_fired_at_step,
        }

    def model_save_data(self, final: bool = False) -> None:
        if final and self.params_and_gradients:
            # Both granularities of the reference's landscape diagnostic
            # (reference/vae.py:143-179): the whole-tree ratio (its
            # accumulated return value) and one ratio per parameter leaf
            # (its per-leaf displacement/inner-product structure).
            self.recorder.correlation_ratios = [
                float(correlation_ratio(self.state.params, p, g))
                for p, g in self.params_and_gradients
            ]
            per_param: dict = {}
            for p, g in self.params_and_gradients:
                for path, r in correlation_ratio_per_param(
                    self.state.params, p, g
                ).items():
                    per_param.setdefault(path, []).append(float(r))
            self.recorder.correlation_ratios_per_param = per_param

    def save(self, final: bool = False) -> None:
        if not is_primary():
            # multi-process: process 0 owns every artifact write; nothing
            # here is a collective (device_get of replicated state is
            # process-local), so other processes skip the whole save
            return
        if final:
            # drain queued --checkpoint_every background writes and surface
            # any failure — a run must not exit "ok" with a broken ckpt
            from ..runio.checkpoint import wait_for_pending_saves

            wait_for_pending_saves()
        # Snapshot everything on the training thread NOW (the recorder and
        # key chain keep mutating), then enqueue the pure host IO on the
        # artifact writer so it overlaps the next train chunks. ~175 ms per
        # save — and epoch mode saves EVERY epoch.
        self.model_save_data(final=final)
        rec_state = self.recorder.to_state()
        state_host = jax.device_get(self.state)
        extra_meta = {
            "current_epsilon": float(
                np.asarray(self.current_epsilon).reshape(-1)[0]
            )
        }
        # In-loop sync saves run inside the event block AFTER this
        # step's print/plot events (batchnum == state.step there); the
        # end-of-run save happens after the loop (batchnum == total-1,
        # step == total) where no events at `step` have fired.
        aux = self._snapshot_aux(
            events_fired_at_step=(self.batchnum == int(state_host.step))
        )
        ckpt_fn = save_checkpoint
        if getattr(self.cfg, "ckpt_backend", "npz") == "orbax":
            from ..runio.checkpoint import save_checkpoint_orbax as ckpt_fn
        dirname, dataset = self.dirname, self.dataset

        def write_run(final=final):
            StatsRecorder.from_state(rec_state).save_npz(dirname, final=final)
            save_model_pkl(
                os.path.join(dirname, "model.pkl"),
                state_host.params,
                state_host.opt_state,
            )
            ckpt_fn(dirname, state_host, extra_meta=extra_meta, aux=aux)
            dataset.save(os.path.join(dirname, "dataset.pk"))

        writer = get_artifact_writer()
        writer.submit(write_run)
        if final:
            # "save(final=True) returned" must mean durable artifacts —
            # run.py exits right after
            writer.drain()
    # NOTE: there is deliberately no Trainer.load() — --state_dict/--data_fn
    # restores happen once in __init__ (and run.py owns dataset loading);
    # a second dead load path is exactly the pattern SURVEY §3.5 flags in
    # the reference (reference/model.py:91-94, never called).
