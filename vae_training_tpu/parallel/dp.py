"""Data-parallel training via shard_map: per-device samplers + psum'd grads.

Each device runs the full scan chunk locally on its shard of the batch; the
only cross-device traffic is one gradient ``pmean`` per step, compiled by
XLA into a collective. Parameters and optimizer state are replicated and updated
identically on every device (the pmean makes updates deterministic across
the mesh), so no parameter communication ever happens.

Per-device randomness: the step key is folded with the device's axis index,
giving independent sampling streams per device — the on-device replacement
for the reference's single host-side key chain.

Two-level data parallelism (``--mesh dp_dcn=S,dp=N`` — S hosts × N
devices): the batch shards over BOTH axes and the gradient reduction is
hierarchical: ``pmean`` over ``dp`` first (within a host), then over
``dp_dcn`` (across hosts) — so only one already-reduced gradient tensor per
host crosses the slower inter-host network per step. The per-device key fold uses the
linearized (dp_dcn, dp) index, which equals the plain ``dp=S*N`` index over
the same device list — the two meshes sample identical per-device batches
and differ only in reduction topology.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..data.base import DistributionDataset
from ..models.networks import VAE
from ..train.state import TrainState
from ..train.step import (StepFns, make_elbo_grad_fn, make_step_fns,
                          sample_z, split_z)


def make_dp_step_fns(
    model: VAE,
    dataset: DistributionDataset,
    tx: optax.GradientTransformation,
    batch_size: int,
    mesh: Mesh,
) -> StepFns:
    dp = mesh.shape["dp"]
    dcn = mesh.shape.get("dp_dcn", 1)
    ndev = dp * dcn
    if batch_size % ndev != 0:
        raise ValueError(
            f"--batch_size {batch_size} must be divisible by "
            f"dp_dcn*dp={ndev}" if dcn > 1 else
            f"--batch_size {batch_size} must be divisible by dp={ndev}"
        )
    local_bs = batch_size // ndev
    latent_dim = model.latent_dim
    data_dim = dataset.dimension

    grad_fn = make_elbo_grad_fn(model)

    def local_step(state: TrainState) -> Tuple[TrainState, jax.Array]:
        idx = jax.lax.axis_index("dp")
        if dcn > 1:
            # linearized (dp_dcn, dp) index == the dp=S*N index (docstring)
            idx = jax.lax.axis_index("dp_dcn") * dp + idx
        kb = jax.random.fold_in(jax.random.fold_in(state.data_key, state.step), idx)
        kz = jax.random.fold_in(jax.random.fold_in(state.model_key, state.step), idx)
        batch = dataset.sample(kb, local_bs)
        z = sample_z(kz, local_bs, latent_dim, data_dim)
        z1, z2 = split_z(z, latent_dim)
        loss, grads = grad_fn(state.params, batch, z1, z2)
        # Equal shards ⇒ mean-of-means is the global-batch mean. Hierarchical
        # when two-level: reduce within the host first, then one reduced
        # tensor crosses hosts.
        grads = jax.lax.pmean(grads, "dp")
        loss = jax.lax.pmean(loss, "dp")
        if dcn > 1:
            grads = jax.lax.pmean(grads, "dp_dcn")
            loss = jax.lax.pmean(loss, "dp_dcn")
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return (
            state.replace(params=params, opt_state=opt_state, step=state.step + 1),
            loss,
        )

    def local_chunk(state: TrainState, n_steps: int):
        def body(s, _):
            return local_step(s)

        return jax.lax.scan(body, state, None, length=n_steps)

    replicated = NamedSharding(mesh, P())

    @partial(jax.jit, static_argnames=("n_steps",), donate_argnames=("state",))
    def train_chunk(state: TrainState, n_steps: int):
        sharded = jax.shard_map(
            partial(local_chunk, n_steps=n_steps),
            mesh=mesh,
            in_specs=(P(),),
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by construction (pmean)
        )
        return sharded(state)

    # Eval/generate/score reuse the single-program path (they run on the
    # replicated params at eval cadence; XLA keeps them on one device or
    # partitions them — either is off the hot path).
    base = make_step_fns(model, dataset, tx, batch_size)

    def replicate(state: TrainState) -> TrainState:
        return jax.device_put(state, replicated)

    return StepFns(
        train_chunk=train_chunk,
        eval_loss=base.eval_loss,
        generate=base.generate,
        score=base.score,
        loss_and_grads=base.loss_and_grads,
        eval_step=base.eval_step,
        place_state=replicate,
    )
