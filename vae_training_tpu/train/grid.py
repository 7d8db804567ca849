"""Batched multi-seed training: the whole seed sweep in ONE device launch.

The reference's sweep scripts run each (seed, config) row as a separate
process (reference/seed_linpadding_expts.sh) — 21 sequential runs.
Here, for a fixed architecture, all seeds train simultaneously as one
``vmap``-ed scan program: dataset manifolds (the ``A`` matrices) and
TrainStates are stacked along a leading grid axis, and XLA batches the tiny
per-seed matmuls into one wide program. This is BASELINE.json config 4
("Batched multi-seed × latent-dim grid via vmap").

Multi-device: ``--seed_grid`` composes with ``--mesh dp=N`` — the seed axis
is sharded over the mesh with ``shard_map`` and each device trains its own
rows with the vmapped chunk. Seeds are independent, so the sharded program
has ZERO collectives. This is the idiomatic multi-device shape for this
workload — scale the sweep, not the (tiny) per-seed batch.

Multi-process (``--multihost``): the same sharded grid spans hosts, and row
OWNERSHIP follows device placement — each process fetches only the rows
whose shards live on its local devices (``fetch_grid_rows``), writes only
its own rows' artifacts into the per-seed outdirs, and prints its own rows'
console lines with a ``[pK]`` process tag. Process 0 creates every row
directory + manifest; a barrier releases the other processes' writes.
Per-row artifacts are bit-identical to the single-process grid run
(tests/test_multihost.py).

Key derivation mirrors the SOLO Trainer exactly (train/loop.py:120-158):
every row shares the single ``PRNGKey(model_seed)`` chain — the reference
runs every sweep row with the same fixed model key
(reference/model.py:29), so rows share init params and the
z/eval-generation streams and differ only in their dataset streams
(``fold_in(PRNGKey(dataset_seed), ...)``). A ``--seed_grid`` launch
therefore produces the SAME run artifacts as per-process solo runs, to
float reassociation of the vmapped program (verified by
tests/test_grid.py).
"""

from __future__ import annotations

import os
from functools import partial
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import NamedSharding, PartitionSpec as P

from ..config import RunConfig
from ..data.base import DistributionDataset
from ..data.registry import get_dataset
from ..evals.stats import StatsRecorder
from ..models.networks import build_vae
from ..models.warm_start import apply_warm_start
from ..ops.elbo import elbo_terms
from ..runio.background import get_artifact_writer
from ..runio.checkpoint import save_checkpoint
from ..runio.export import save_model_pkl
from ..runio.outdir import make_output_dir
from .loop import EVAL_BATCH_SIZE, N_PLOT, N_PRINT, next_event
from .state import TrainState, make_adam
from .step import sample_z, split_z


def stack_pytrees(trees):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *trees)


def fetch_grid_rows(tree, rows, n_rows: int):
    """Host copies ``{row: pytree_row}`` of grid rows from a tree whose
    array leaves lead with the row axis (of length ``n_rows``), touching
    only ADDRESSABLE shards.

    The multi-process grid shards the seed axis across processes;
    ``jax.device_get`` of the full global array would fail on the shards
    other processes own, so every host-side consumer (stats, saves, plots,
    loss recording) goes through this instead — each process fetches
    exactly the rows it owns. Single-process, every shard is addressable
    and ``rows`` covers the whole grid, so the fetch is ONE batched
    ``device_get`` of the tree instead of a host transfer per
    (leaf × shard)."""
    want = set(rows)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    for leaf in leaves:
        if getattr(leaf, "ndim", 1) >= 1 and leaf.shape[0] != n_rows:
            raise ValueError(
                f"fetch_grid_rows: leaf row axis {leaf.shape[0]} != grid "
                f"size {n_rows}")
    if jax.process_count() == 1:
        host = [np.asarray(l) for l in jax.device_get(leaves)]
        return {
            r: jax.tree_util.tree_unflatten(treedef, [l[r] for l in host])
            for r in sorted(want)
        }
    per_leaf = []
    for leaf in leaves:
        got = {}
        if not isinstance(leaf, jax.Array):
            arr = np.asarray(leaf)
            for r in want:
                got[r] = arr[r]
        else:
            for sh in leaf.addressable_shards:
                sl = sh.index[0] if sh.index else slice(None)
                start, stop, step = sl.indices(leaf.shape[0])
                data = None  # one host transfer per shard, fetched lazily
                for off, r in enumerate(range(start, stop, step)):
                    if r in want and r not in got:
                        if data is None:
                            data = np.asarray(sh.data)
                        got[r] = data[off]
        missing = want - set(got)
        if missing:
            raise ValueError(
                f"grid rows {sorted(missing)} are not addressable on "
                f"process {jax.process_index()}; a process may only fetch "
                f"rows whose shards live on its local devices")
        per_leaf.append(got)
    return {
        r: jax.tree_util.tree_unflatten(treedef, [pl[r] for pl in per_leaf])
        for r in sorted(want)
    }


class GridTrainer:
    """Train one config across many dataset seeds in a single launch."""

    def __init__(self, cfg: RunConfig, seeds: Sequence[int]):
        self.cfg = cfg
        self.seeds = list(seeds)
        self.n_print = getattr(cfg, "n_print", N_PRINT) or N_PRINT
        self.n_plot = getattr(cfg, "n_plot", N_PLOT) or N_PLOT
        self.eval_batch_size = EVAL_BATCH_SIZE

        self.datasets: List[DistributionDataset] = [
            get_dataset(cfg.dataset, s, cfg) for s in seeds
        ]
        if any(d.is_epochs for d in self.datasets):
            raise NotImplementedError(
                "--seed_grid supports distribution datasets; epoch-mode "
                "image corpora train one run at a time"
            )
        if cfg.state_dict:
            raise NotImplementedError(
                "--seed_grid starts fresh or resumes from its own row "
                "checkpoints (--resume); --state_dict applies to solo runs"
            )
        if getattr(cfg, "track_correlation", False):
            raise NotImplementedError(
                "--track_correlation is a solo-run diagnostic (per-parameter "
                "ratios against a converged target); run the row without "
                "--seed_grid to record it"
            )
        if getattr(cfg, "latent_distribution", "gaussian") != "gaussian":
            raise NotImplementedError(
                "--seed_grid supports the gaussian latent distribution "
                "(the CLI forces gaussian like the reference, run.py:41)"
            )
        if getattr(cfg, "ckpt_backend", "npz") != "npz":
            raise NotImplementedError(
                "--seed_grid checkpoints every row through the npz "
                "path: its .prev retention is what lets restore roll "
                "skew-killed rows back to the grid's common step "
                "(rollback has no orbax implementation, and N tensorstore "
                "directories per save event would serialize the async "
                "writer); --ckpt_backend orbax is a solo-run option"
            )
        # cfg.resume for grid runs means "resume every row from its own
        # output dir" — run_seed_grid calls restore(outdirs) after building
        # the per-seed directories.
        self.mesh = None
        if cfg.mesh:
            from ..parallel.mesh import make_mesh, parse_mesh_spec

            axes = parse_mesh_spec(cfg.mesh)
            if axes.get("tp", 1) > 1:
                raise ValueError(
                    "--seed_grid shards SEEDS over the mesh; use a pure dp "
                    "spec (e.g. --mesh dp=8), tp does not apply"
                )
            if axes.get("dp_dcn", 1) > 1:
                raise ValueError(
                    "--seed_grid with dp_dcn makes no sense: the sharded "
                    "grid chunk has ZERO collectives (seeds are "
                    "independent), so there is nothing for a cross-host "
                    "axis to reduce — launch one grid per host instead "
                    "(same aggregate throughput, no cross-host dependency)"
                )
            self.mesh = make_mesh(
                cfg.mesh,
                allow_uneven=getattr(cfg, "mesh_allow_uneven", False))
            dp = self.mesh.shape["dp"]
            if len(self.seeds) % dp != 0:
                raise ValueError(
                    f"--seed_grid with --mesh dp={dp} needs the seed count "
                    f"to divide evenly; got {len(self.seeds)} seeds"
                )
        # Multi-process grid (--multihost --seed_grid): the seed axis shards
        # across processes and each process OWNS its local devices' rows —
        # it fetches only addressable shards and writes/prints only its own
        # rows' artifacts (the sharded chunk has zero collectives, so
        # scale-out is pure row partitioning). Fail fast on shapes where
        # ownership can't be established.
        self._owned_rows = list(range(len(self.seeds)))
        if jax.process_count() > 1:
            if self.mesh is None:
                raise ValueError(
                    "--seed_grid under --multihost requires a dp mesh "
                    "(--mesh dp=N): seed rows must shard across processes "
                    "so each process owns and writes its own rows"
                )
            mesh_procs = {d.process_index for d in self.mesh.devices.flat}
            if mesh_procs != set(range(jax.process_count())):
                raise ValueError(
                    f"--seed_grid --multihost: the mesh must span every "
                    f"process (mesh covers processes {sorted(mesh_procs)} "
                    f"of {jax.process_count()}); size dp to the global "
                    f"device count"
                )
        if cfg.arch == "conv":
            raise ValueError("--seed_grid supports the MLP VAE architectures")
        data_dim = self.datasets[0].dimension
        self.data_dim = data_dim
        self.latent_dim = cfg.latent_dimension
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
        self.tx = make_adam(cfg.learning_rate,
                            getattr(cfg, "adam_dtype", "f32"))
        self.dataset_grid = stack_pytrees(self.datasets)

        # Key chain identical to the solo Trainer's (train/loop.py:120-158):
        # PRNGKey(model_seed) → vae init key → [warm-start key] → z base key
        # → host eval/plot chain. Each solo run consumes the SAME chain (the
        # dataset seed only drives the data streams), so one chain serves
        # every row and grid rows start from the solo runs' exact draws.
        base = jax.random.PRNGKey(cfg.model_seed)
        vae_key, base = jax.random.split(base)
        ws_key = None
        if cfg.warm_start:
            ws_key, base = jax.random.split(base)
        z_key, base = jax.random.split(base)
        seeds_arr = jnp.asarray(list(seeds), jnp.uint32)

        if cfg.warm_start:
            # Warm starts are per-row analytic inits over each row's
            # manifold. The linear family's pinv(A) is a one-off host
            # computation on a tiny matrix — precompute it per row from the
            # host-resident A with numpy; the init draws, warm-start
            # surgery, and state assembly run as ONE jitted program.
            model, tx, latent_dim = self.model, self.tx, self.latent_dim
            dataset_name = cfg.dataset
            lod = cfg.latent_off_dimension
            pinv_stack = None
            if dataset_name == "linear_gaussian":
                pinv_stack = jnp.asarray(np.stack([
                    np.linalg.pinv(np.asarray(d.A)) for d in self.datasets]))

            @jax.jit
            def make_ws_state_grid(vae_key, ws_key, z_key, seeds_arr,
                                   dataset_grid, pinv_stack):
                init_params = model.init(
                    vae_key,
                    jnp.zeros((1, data_dim)),
                    jnp.zeros((1, latent_dim)),
                    jnp.zeros((1, data_dim)),
                )["params"]

                def one(seed, dataset, pinv):
                    params = apply_warm_start(
                        dict(init_params), dataset_name, dataset,
                        latent_dim, lod, ws_key, pinv=pinv,
                    )
                    return TrainState.create(
                        params=params, tx=tx, model_key=z_key,
                        data_key=jax.random.fold_in(
                            jax.random.PRNGKey(seed), 1),
                    )

                return jax.vmap(
                    one, in_axes=(0, 0, None if pinv_stack is None else 0)
                )(seeds_arr, dataset_grid, pinv_stack)

            self.state_grid = make_ws_state_grid(
                vae_key, ws_key, z_key, seeds_arr, self.dataset_grid,
                pinv_stack)
        else:
            # Every row starts from the SAME init draws (the model-key
            # chain is seed-independent — solo parity), so the whole grid
            # state is ONE compiled program: init params once, vmap the
            # per-seed state creation (params/moments broadcast, data keys
            # fold_in per seed) instead of hundreds of small eager
            # dispatches per seed.
            model, tx, latent_dim = self.model, self.tx, self.latent_dim

            @jax.jit
            def make_state_grid(vae_key, z_key, seeds_arr):
                init_params = model.init(
                    vae_key,
                    jnp.zeros((1, data_dim)),
                    jnp.zeros((1, latent_dim)),
                    jnp.zeros((1, data_dim)),
                )["params"]

                def one(seed):
                    return TrainState.create(
                        params=init_params, tx=tx, model_key=z_key,
                        data_key=jax.random.fold_in(
                            jax.random.PRNGKey(seed), 1),
                    )

                return jax.vmap(one)(seeds_arr)

            self.state_grid = make_state_grid(vae_key, z_key, seeds_arr)
        if self.mesh is not None:
            # seed axis sharded over dp: each device owns its rows, zero
            # cross-device traffic in the training chunk
            row_sharded = NamedSharding(self.mesh, P("dp"))
            src_state, src_data = self.state_grid, self.dataset_grid
            if jax.process_count() > 1:
                # stage through host: each process built the SAME full grid
                # (deterministic from seeds), and device_put of a host value
                # onto a cross-process sharding takes each process's
                # addressable slices locally — the canonical way to form a
                # global array without collectives
                src_state = jax.device_get(src_state)
                src_data = jax.device_get(src_data)
            self.state_grid = jax.device_put(src_state, row_sharded)
            self.dataset_grid = jax.device_put(src_data, row_sharded)
            if jax.process_count() > 1:
                imap = row_sharded.devices_indices_map((len(self.seeds),))
                owned = set()
                for d, idx in imap.items():
                    if d.process_index == jax.process_index():
                        owned.update(range(*idx[0].indices(len(self.seeds))))
                self._owned_rows = sorted(owned)
        # console lines carry a process tag in multi-process runs (each row
        # is printed by exactly one process — its owner)
        self._proc_prefix = (f"[p{jax.process_index()}] "
                             if jax.process_count() > 1 else "")
        # shared host chain = the solo Trainer's self.key after init; eval
        # data streams are per-row fold_in(PRNGKey(seed), 2) roots with a
        # shared counter, exactly loop.py's _next_eval_data_key
        self._host_key = base
        self._eval_data_roots = jax.jit(
            jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(s), 2))
        )(seeds_arr)
        self._eval_counter = 0

        self.recorders = [StatsRecorder() for _ in seeds]
        self.current_epsilon = [cfg.epsilon] * len(seeds)
        self.batchnum = 0
        self._skip_events_at = -1  # set by restore() when events already ran
        self._build_fns()

    # ------------------------------------------------------------------
    def _build_fns(self):
        model, tx = self.model, self.tx
        batch_size = self.cfg.batch_size
        latent_dim, data_dim = self.latent_dim, self.data_dim

        def loss_fn(params, batch, z1, z2):
            x_hat, mu, logvar_e, epsilon = model.apply(
                {"params": params}, batch, z1, z2)
            loss, dkl, mse = elbo_terms(batch, x_hat, mu, logvar_e, epsilon)
            return loss, (dkl, mse, logvar_e, epsilon)

        grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

        def one_step(dataset, state):
            kb = jax.random.fold_in(state.data_key, state.step)
            kz = jax.random.fold_in(state.model_key, state.step)
            batch = dataset.sample(kb, batch_size)
            z = sample_z(kz, batch_size, latent_dim, data_dim)
            z1, z2 = split_z(z, latent_dim)
            (loss, _), grads = grad_fn(state.params, batch, z1, z2)
            updates, opt_state = tx.update(grads, state.opt_state, state.params)
            params = optax.apply_updates(state.params, updates)
            return state.replace(
                params=params, opt_state=opt_state, step=state.step + 1
            ), loss

        def chunk_one(dataset, state, n_steps):
            def body(s, _):
                return one_step(dataset, s)

            return jax.lax.scan(body, state, None, length=n_steps)

        def chunk_rows(dataset_grid, state_grid, n_steps):
            """Raw (unjitted) multi-row chunk; also the per-shard body."""
            return jax.vmap(
                partial(chunk_one, n_steps=n_steps)
            )(dataset_grid, state_grid)

        self._train_chunk = self._wrap_grid_chunk(chunk_rows)
        self._build_eval(model, batch_size, latent_dim, data_dim)

    def _wrap_grid_chunk(self, rows_fn):
        """jit a raw ``(dataset_grid, state_grid, n_steps=)`` chunk; with
        --mesh, shard the seed axis over dp via shard_map first (seeds are
        independent ⇒ zero collectives; check_vma off — every output is
        row-sharded by construction)."""
        if self.mesh is None:
            return partial(jax.jit, static_argnames=("n_steps",),
                           donate_argnames=("state_grid",))(rows_fn)
        mesh = self.mesh

        @partial(jax.jit, static_argnames=("n_steps",),
                 donate_argnames=("state_grid",))
        def sharded(dataset_grid, state_grid, n_steps: int):
            return jax.shard_map(
                partial(rows_fn, n_steps=n_steps),
                mesh=mesh,
                in_specs=(P("dp"), P("dp")),
                out_specs=(P("dp"), P("dp")),
                check_vma=False,
            )(dataset_grid, state_grid)

        return sharded

    def _build_eval(self, model, batch_size, latent_dim, data_dim):

        score_on_host = getattr(self.datasets[0], "score_on_host", False)

        @jax.jit
        def eval_grid(dataset_grid, state_grid, eval_keys, gen_key, epsilons):
            # the z draw is SHARED across rows (in_axes None): every solo
            # run consumes the identical host chain, so its eval z is the
            # same — only the real-data key differs per row
            def one(dataset, state, eps, ekey, zkey):
                real = dataset.sample(ekey, self.eval_batch_size)
                z = sample_z(zkey, self.eval_batch_size, latent_dim, data_dim)
                z1, z2 = split_z(z, latent_dim)
                fake = model.apply(
                    {"params": state.params}, z1, z2, eps,
                    method=type(model).generate)
                x_hat, mu, logvar_e, epsilon = model.apply(
                    {"params": state.params}, real, z1, z2)
                loss, dkl, mse = elbo_terms(real, x_hat, mu, logvar_e, epsilon)
                # host-only scoring datasets hand the batch back instead
                score = {"_fake": fake} if score_on_host else dataset.score(fake)
                return loss, dkl, mse, logvar_e, epsilon, score

            return jax.vmap(one, in_axes=(0, 0, 0, 0, None))(
                dataset_grid, state_grid, epsilons, eval_keys, gen_key)

        self._eval_grid = eval_grid

        @jax.jit
        def banner_grid(dataset_grid, keys):
            # the start-of-run "Score for real data" banner for every seed
            # in ONE compiled call
            def one(dataset, k):
                batch = dataset.sample(k, self.eval_batch_size)
                return {"_batch": batch} if score_on_host \
                    else dataset.score(batch)
            return jax.vmap(one)(dataset_grid, keys)

        self._banner_grid = banner_grid

    # ------------------------------------------------------------------
    def _next_event(self, b: int) -> int:
        return next_event(b, self.cfg.num_batches, self.n_print, self.n_plot)

    def maybe_print_banner(self):
        """Per-row "Score for real data" banner at a fresh train start —
        the solo engine's first eval-key consumption
        (train/loop.py:train_distribution start); key-stream parity with
        solo runs depends on consuming counter value 1 here."""
        if self._eval_counter != 0:
            return None  # resumed with host state: the banner key was consumed
        self._eval_counter += 1
        keys = jax.vmap(
            lambda r: jax.random.fold_in(r, self._eval_counter)
        )(self._eval_data_roots)
        rows = fetch_grid_rows(self._banner_grid(self.dataset_grid, keys),
                               self._owned_rows, len(self.seeds))
        scores = []
        for i in self._owned_rows:
            out = rows[i]
            if "_batch" in out:
                score = self.datasets[i].score_host(np.asarray(out["_batch"]))
            else:
                # 0-d np arrays: the solo banner's exact console repr
                score = {k: np.asarray(v) for k, v in out.items()}
            print(f"{self._proc_prefix}[seed {self.seeds[i]}] "
                  f"Score for real data: {score}", flush=True)
            scores.append(score)
        return scores

    def compute_and_write_stats(self):
        # ONE host split + one eval-counter tick per eval event — the solo
        # engine's exact consumption order (compute_stats: get_key() then
        # _next_eval_data_key())
        self._host_key, gen_key = jax.random.split(self._host_key)
        self._eval_counter += 1
        eval_keys = jax.vmap(
            lambda r: jax.random.fold_in(r, self._eval_counter)
        )(self._eval_data_roots)
        eps = self._eps_array()
        rows = fetch_grid_rows(
            self._eval_grid(self.dataset_grid, self.state_grid, eval_keys,
                            gen_key, eps),
            self._owned_rows, len(self.seeds),
        )
        for i in self._owned_rows:
            loss, dkl, mse, logvar_e, epsilon, score = rows[i]
            rec = self.recorders[i]
            rec.append_eval(loss, logvar_e, epsilon)
            self.current_epsilon[i] = epsilon
            stats = {"VAE Loss": loss, "KL divergence": dkl, "mse": mse}
            if "_fake" in score:
                stats.update(self.datasets[i].score_host(
                    np.asarray(score["_fake"])))
            else:
                stats.update(score)
            msg = rec.write_stats(self.batchnum, stats)
            print(f"{self._proc_prefix}[seed {self.seeds[i]}] {msg}",
                  flush=True)

    def _eps_array(self):
        """The per-row decoder log-variance as a device operand. Each
        process only tracks ``current_epsilon`` for rows it owns, so in
        multi-process runs the array is assembled ROW-SHARDED from each
        process's ADDRESSABLE shards of its local copy — the stale
        non-owned entries never reach a device. (A plain device_put of the
        host value would require the value to be identical on every
        process — jax asserts it — which it deliberately is not.)"""
        eps = np.asarray(
            [float(np.asarray(e).reshape(-1)[0]) for e in self.current_epsilon],
            np.float32,
        )
        if jax.process_count() > 1:
            sharding = NamedSharding(self.mesh, P("dp"))
            shape = (len(self.seeds),)
            shards = [
                jax.device_put(eps[idx], d)
                for d, idx in
                sharding.addressable_devices_indices_map(shape).items()
            ]
            return jax.make_array_from_single_device_arrays(
                shape, sharding, shards)
        return jnp.asarray(eps)

    def save_all(self, outdirs, final=False):
        # unstack the owned grid rows once on host (multi-process: each
        # process saves exactly the rows it owns — every row is written by
        # exactly one process)
        state_rows = fetch_grid_rows(self.state_grid, self._owned_rows,
                                     len(self.seeds))
        # In-loop saves run inside the event block AFTER this step's events
        # (batchnum == step); the end-of-run save happens after the loop
        # (batchnum == total-1, step == total).
        first = state_rows[self._owned_rows[0]]
        events_fired = self.batchnum == int(
            np.asarray(first.step).reshape(-1)[0])
        # Everything below is pure host IO (~175 ms/row: checkpoint
        # serialize + model.pkl + losses.npz) — enqueued on the artifact
        # writer so it overlaps the next train chunks. All mutable inputs
        # are snapshotted HERE, at submit time: the recorder via to_state()
        # (training keeps appending while the write is in flight), the
        # host key / eval counter as plain values, and state_i is an
        # already-fetched immutable host pytree. FIFO order keeps the
        # per-dir npz → pkl → checkpoint sequence and the checkpoint
        # step-ordering guard intact.
        writer = get_artifact_writer()
        for i in self._owned_rows:
            out = outdirs[i]
            state_i = state_rows[i]
            rec_state = self.recorders[i].to_state()
            extra_meta = {"current_epsilon": float(
                np.asarray(self.current_epsilon[i]).reshape(-1)[0])}
            aux = {
                "recorder": rec_state,
                "host_key": np.asarray(self._host_key),
                "eval_counter": self._eval_counter,
                "events_fired_at_step": events_fired,
            }

            def write_row(out=out, state_i=state_i, rec_state=rec_state,
                          extra_meta=extra_meta, aux=aux, final=final):
                StatsRecorder.from_state(rec_state).save_npz(out, final=final)
                save_model_pkl(os.path.join(out, "model.pkl"), state_i.params,
                               state_i.opt_state)
                # per-seed full checkpoint + host-side run state: the whole
                # grid resumes with --resume (artifacts identical to an
                # uninterrupted sweep), and any row can still be resumed
                # solo with --resume <name>_seed<N>
                save_checkpoint(out, state_i, extra_meta=extra_meta, aux=aux)

            writer.submit(write_row)
        if final:
            # "save_all(final=True) returned" must mean durable artifacts
            # (run_seed_grid ends on it)
            writer.drain()

    def restore(self, outdirs) -> None:
        """Resume the whole grid from each row's own checkpoint (written by
        a previous save_all). All rows checkpoint at the same events, so
        their steps agree; the shared host key chain is restored from row 0.
        Keys are per-step fold_in, so the resumed trajectory is bit-exact
        under any chunking."""
        from ..runio.checkpoint import (checkpoint_exists,
                                        promote_prev_checkpoint,
                                        read_checkpoint_meta,
                                        restore_checkpoint,
                                        restore_checkpoint_aux,
                                        restore_checkpoint_prev)
        from ..utils.process import check_shared_fs

        # per-ROW visibility: with per-host disks every process sees only
        # its own rows, and a single all() aggregate would agree on False
        # everywhere and wave the guard through (see check_shared_fs)
        check_shared_fs([checkpoint_exists(o) for o in outdirs],
                        os.path.dirname(outdirs[0]) or outdirs[0],
                        what="grid row checkpoints")
        # One owned row serves as the restore template for EVERY row (all
        # rows share shapes/dtypes). Multi-process: each process restores
        # all rows from disk to rebuild the full grid — like the solo
        # multihost resume, this requires the checkpoints on a filesystem
        # visible to every process (docs/architecture.md, Scale-out).
        template = fetch_grid_rows(
            self.state_grid, [self._owned_rows[0]], len(self.seeds)
        )[self._owned_rows[0]]
        # Pass 1: every row's NEWEST checkpoint.
        restored, steps = [], []
        for out in outdirs:
            state_i = restore_checkpoint(out, template)
            steps.append(int(state_i.step))
            restored.append(state_i)
        # Pass 2 — rollback to the newest COMMON step. Rows save through
        # per-process FIFO writers, so a SIGKILL (multihost preemption) can
        # land between two rows' — or two processes' — flushes, stranding
        # rows one save event apart. All rows save at the same events, so
        # the retained .prev checkpoint of a row that got ahead is exactly
        # at the common step; roll it back instead of refusing to resume.
        target = min(steps)
        rolled = [i for i, s in enumerate(steps) if s != target]
        for i in rolled:
            out = outdirs[i]
            try:
                prev_state = restore_checkpoint_prev(out, template)
            except OSError:
                prev_state = None
            prev_step = None if prev_state is None else int(prev_state.step)
            if prev_step != target:
                raise ValueError(
                    f"grid rows checkpointed at different steps "
                    f"{sorted(set(steps))}, and {out} (step {steps[i]}) has "
                    f"no retained previous checkpoint at the common step "
                    f"{target} (found: {prev_step}). A kill between row "
                    f"flushes skews rows by at most one save event — this "
                    f"is further; resume rows solo with "
                    f"--resume <name>_seed<N>")
            print(f"[resume] {self._proc_prefix}{out}: rolling back from "
                  f"step {steps[i]} to the grid's common step {target} "
                  f"(retained .prev checkpoint)", flush=True)
            restored[i] = prev_state
            steps[i] = target
        rolled_set = set(rolled)
        # Pass 3: meta (current_epsilon) + aux (recorder history, host key
        # chain) — the .prev versions for rolled-back rows, with a fallback
        # to the current files when a previous rollback's promotion was
        # itself interrupted (the trio self-heals: any member already
        # promoted carries the target step).
        for i, out in enumerate(outdirs):
            use_prev = i in rolled_set
            meta = read_checkpoint_meta(out, prev=use_prev)
            if meta is None or meta.get("step") != steps[i]:
                # the other version may hold the matching step (a kill mid
                # retention/promotion, or pass 1 falling back to .prev)
                meta = read_checkpoint_meta(out, prev=not use_prev)
            if meta is not None and meta.get("step") != steps[i]:
                meta = None
            if meta and "current_epsilon" in meta:
                self.current_epsilon[i] = meta["current_epsilon"]
            aux = restore_checkpoint_aux(out, prev=use_prev)
            if aux is None or aux.get("step") != steps[i]:
                aux = restore_checkpoint_aux(out, prev=not use_prev)
            if aux is not None and aux.get("step", steps[i]) != steps[i]:
                print(f"[resume] {out}: aux is from step {aux['step']}, "
                      f"state is at {steps[i]}; resuming this row without "
                      f"host-side history", flush=True)
                aux = None
            if aux is not None:
                self.recorders[i] = StatsRecorder.from_state(aux["recorder"])
                if i == 0:
                    self._host_key = jnp.asarray(aux["host_key"])
                    # eval stream position; pre-round-3 checkpoints lack the
                    # field — reconstruct it as banner + one per recorded
                    # eval (var_enc gains exactly one entry per eval;
                    # vae_losses would overcount — it interleaves train
                    # chunks with eval scalars)
                    self._eval_counter = int(aux.get(
                        "eval_counter",
                        1 + len(self.recorders[0].var_enc)))
                    if aux.get("events_fired_at_step", False):
                        self._skip_events_at = steps[0]
        # Every process must finish READING the checkpoint files before ANY
        # process may mutate them — the promotion below, or the resumed
        # run's first save after restore returns. Without this, a fast
        # process that restored rolled=[] could land a post-restore save
        # (whose retention moves the common-step trio to .prev) while a
        # slow process is still in Pass 1, making the two derive DIFFERENT
        # rollback sets — one of them then blocks forever in a barrier the
        # other never enters, or raises a spurious skew error. The barrier
        # is therefore UNCONDITIONAL (not gated on this process's rolled
        # set); after it, all reads saw the same static files, so every
        # process computed the same rollback decisions.
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("vae_grid_restore_read")
        # Promote the rolled-back rows' .prev trios to CURRENT — left in
        # place, the newer save's meta step would make the ordering guard
        # refuse every subsequent checkpoint of the resumed run. Each row
        # is promoted only by its owner (the one process that will ever
        # write it again), so promotions never race another process's
        # saves either.
        for i in rolled:
            if jax.process_count() == 1 or i in self._owned_rows:
                promote_prev_checkpoint(outdirs[i])
        self.batchnum = steps[0]
        self.state_grid = stack_pytrees(restored)
        if self.mesh is not None:
            src = (jax.device_get(self.state_grid)
                   if jax.process_count() > 1 else self.state_grid)
            self.state_grid = jax.device_put(
                src, NamedSharding(self.mesh, P("dp")))

    def plot_all(self, outdirs):
        """Per-seed diagnostic plots from vmapped ancestral sampling."""
        self._host_key, gen_key = jax.random.split(self._host_key)
        eps = self._eps_array()
        if getattr(self, "_plot_generate", None) is None:
            # jitted ONCE per trainer (gen_key is an argument, not a
            # closure) — a fresh jit per plot event would recompile the
            # vmapped sampler at every plot/save cadence. The z draw is
            # SHARED across rows: solo runs all consume the identical host
            # chain (train/loop.py:plot_epoch's single get_key()).
            model = self.model
            latent_dim, data_dim = self.latent_dim, self.data_dim
            batch = self.eval_batch_size

            def one(state, ep_i, key):
                z = sample_z(key, batch, latent_dim, data_dim)
                z1, z2 = split_z(z, latent_dim)
                return model.apply({"params": state.params}, z1, z2, ep_i,
                                   method=type(model).generate)

            self._plot_generate = jax.jit(
                jax.vmap(one, in_axes=(0, 0, None)))

        fakes = fetch_grid_rows(
            self._plot_generate(self.state_grid, eps, gen_key),
            self._owned_rows, len(self.seeds))
        # matplotlib per row — off the critical path. ALL figure
        # writing during a grid run rides the single artifact-writer thread
        # (pyplot is not multi-thread-safe); `fakes` is host data by now.
        writer = get_artifact_writer()
        for i in self._owned_rows:
            fn = os.path.join(outdirs[i], f"output_{self.batchnum}.png")
            writer.submit(partial(self.datasets[i].plot_batch, fakes[i], fn=fn))

    def train(self, outdirs):
        try:
            self.maybe_print_banner()
            total = self.cfg.num_batches
            b = self.batchnum  # 0 fresh; the checkpoint step after restore()
            while b < total:
                self.batchnum = b
                if b % self.n_print == 0 and b != self._skip_events_at:
                    self.compute_and_write_stats()
                if (b % self.n_plot == 0 or b == total - 1) \
                        and b != self._skip_events_at:
                    self.plot_all(outdirs)
                    self.save_all(outdirs)
                n = self._next_event(b) - b
                self.state_grid, losses = self._train_chunk(
                    self.dataset_grid, self.state_grid, n)
                # (n_seeds, n) row-sharded: record the rows owned here
                loss_rows = fetch_grid_rows(losses, self._owned_rows,
                                            len(self.seeds))
                for i in self._owned_rows:
                    self.recorders[i].append_train_losses(loss_rows[i])
                b += n
            self.batchnum = max(total - 1, 0)
        except BaseException:
            # flush pending artifact writes (the last durable checkpoint a
            # supervised retry resumes from) without masking the training
            # error
            get_artifact_writer().drain_quietly()
            raise
        # train() returned ⇒ every in-loop artifact is on disk
        get_artifact_writer().drain()


def per_group_chunk(groups, state_grids, n_steps):
    """Advance several grid trainers' states by ``n_steps`` each — one
    launch per group (bench's grid workloads; every group is one
    (data, padding, latent) row of a sweep family with all its seeds)."""
    outs = [g._train_chunk(g.dataset_grid, sg, n_steps)
            for g, sg in zip(groups, state_grids)]
    return tuple(o[0] for o in outs), tuple(o[1] for o in outs)


def run_seed_grid(cfg: RunConfig, seeds: Sequence[int], name_fn=None) -> int:
    """CLI entry: one launch, per-seed output dirs.

    ``name_fn(seed) -> str`` overrides the default ``<name>_seed<N>`` output
    naming (the in-process sweep runner uses it to keep the reference's run
    names).
    """
    if name_fn is None:
        name_fn = lambda seed: f"{cfg.name}_seed{seed}"
    trainer = GridTrainer(cfg, seeds)
    outdirs = []
    for seed in seeds:
        sub = cfg.__class__(**{**cfg.to_json_dict()})
        sub.dataset_seed = seed
        outdirs.append(
            make_output_dir(name_fn(seed), cfg.overwrite, sub,
                            data_dir=cfg.data_dir,
                            reuse_existing=bool(cfg.resume))
        )
    if jax.process_count() > 1:
        # process 0 created every row dir + manifest above (make_output_dir
        # is primary-gated); barrier so other processes don't write their
        # owned rows' artifacts into not-yet-created directories. Requires
        # the data dir on a shared filesystem (docs/architecture.md).
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("vae_grid_outdirs")
    if cfg.resume:
        trainer.restore(outdirs)
    trainer.train(outdirs)
    trainer.save_all(outdirs, final=True)
    return 0
