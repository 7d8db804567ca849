"""The fused train step and scan-chunked training program.

Accelerator-first inversion of the reference's hot loop. The reference dispatches,
per step, from Python: a dataset sample (several small XLA ops), a host key
split, a (batch, latent+data) normal draw, and the jitted train_step
(reference/model.py:213-222, reference/vae.py:123-129). That
per-step host dispatch is the throughput ceiling. Here ONE jitted,
donated-buffer program runs ``n_steps`` steps under ``lax.scan``:

    fold_in(step) → sample batch on-device → sample z → ELBO fwd/bwd →
    Adam update

and returns the per-step losses (preserving the reference's per-step
``vae_losses`` stat channel — reference/vae.py:130). The host wakes
only at eval cadence.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..data.base import DistributionDataset
from ..models.networks import VAE
from ..ops.elbo import elbo_terms
from .state import TrainState


class StepFns(NamedTuple):
    """Compiled entry points the training engine drives."""

    train_chunk: Callable  # (state, n_steps) -> (state, losses[n_steps])
    eval_loss: Callable  # (params, batch, z1, z2) -> (loss, dkl, mse, logvar_e, eps)
    generate: Callable  # (params, z1, z2, epsilon) -> x_hat
    score: Callable  # (batch,) -> dict of scalars
    loss_and_grads: Callable  # (params, batch, z1, z2) -> (loss, grads)
    # Optional hook: place the initial TrainState onto a device mesh
    # (replicate or shard) before training. None ⇒ single-device.
    place_state: Optional[Callable] = None
    # Fused eval: (params, data_key, z_key, epsilon_scalar) -> stats dict.
    # One device program for real-batch sampling + generation + ELBO
    # decomposition + analytic scoring (the reference runs ~6 separate
    # dispatches per eval: reference/model.py:153-168).
    eval_step: Optional[Callable] = None


def sample_z(key: jax.Array, n: int, latent_dim: int, data_dim: int) -> jax.Array:
    """One gaussian draw of shape (n, latent_dim + data_dim): z1 for the
    reparameterisation, z2 for the decoder output noise.

    Reference: reference/model.py:225-228 + split at vae.py:127-128.
    """
    return jax.random.normal(key, (n, latent_dim + data_dim))


def split_z(z: jax.Array, latent_dim: int) -> Tuple[jax.Array, jax.Array]:
    return z[..., :latent_dim], z[..., latent_dim:]


def make_elbo_grad_fn(model: VAE):
    """value_and_grad of the scalar ELBO loss — the ONE loss closure shared
    by the epoch path and the dp/gspmd parallel backends (make_step_fns
    keeps its own has_aux variant for the stat channels). A loss change
    made here reaches every backend."""

    def loss_fn(params, batch, z1, z2):
        x_hat, mu, logvar_e, epsilon = model.apply(
            {"params": params}, batch, z1, z2)
        # epoch-mode conv batches arrive NHWC (see make_epoch_chunk's corpus
        # layout note); the ELBO is always over flattened pixels, matching
        # the reference's vectorized images (reference/vae.py:124).
        # For the flat paths this reshape is the identity.
        flat = batch.reshape(batch.shape[0], -1)
        loss, _, _ = elbo_terms(flat, x_hat, mu, logvar_e, epsilon)
        return loss

    return jax.value_and_grad(loss_fn)


def make_step_fns(
    model: VAE,
    dataset: DistributionDataset,
    tx: optax.GradientTransformation,
    batch_size: int,
) -> StepFns:
    latent_dim = model.latent_dim
    data_dim = dataset.dimension

    def loss_fn(params, batch, z1, z2):
        x_hat, mu, logvar_e, epsilon = model.apply({"params": params}, batch, z1, z2)
        loss, dkl, mse = elbo_terms(batch, x_hat, mu, logvar_e, epsilon)
        return loss, (dkl, mse, logvar_e, epsilon)

    grad_fn = jax.value_and_grad(loss_fn, has_aux=True)

    def train_step(state: TrainState) -> Tuple[TrainState, jax.Array]:
        kb = jax.random.fold_in(state.data_key, state.step)
        kz = jax.random.fold_in(state.model_key, state.step)
        batch = dataset.sample(kb, batch_size)
        z = sample_z(kz, batch_size, latent_dim, data_dim)
        z1, z2 = split_z(z, latent_dim)
        (loss, _), grads = grad_fn(state.params, batch, z1, z2)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        new_state = state.replace(
            params=params, opt_state=opt_state, step=state.step + 1
        )
        return new_state, loss

    @partial(jax.jit, static_argnames=("n_steps",), donate_argnames=("state",))
    def train_chunk(state: TrainState, n_steps: int):
        def body(s, _):
            return train_step(s)

        return jax.lax.scan(body, state, None, length=n_steps)

    @jax.jit
    def eval_loss(params, batch, z1, z2):
        """Eval-mode ELBO decomposition.

        Matches the reference's jitted ``VAE.loss``
        (reference/networks.py:103-113): same forward as training,
        returns component means plus the current logvar_e / epsilon params.
        """
        x_hat, mu, logvar_e, epsilon = model.apply({"params": params}, batch, z1, z2)
        loss, dkl, mse = elbo_terms(batch, x_hat, mu, logvar_e, epsilon)
        return loss, dkl, mse, logvar_e, epsilon

    @jax.jit
    def generate(params, z1, z2, epsilon):
        """Ancestral sampling — jitted ONCE (the reference re-jits a fresh
        partial on every call: reference/vae.py:199)."""
        return model.apply(
            {"params": params}, z1, z2, epsilon, method=type(model).generate
        )

    @jax.jit
    def score(batch):
        return dataset.score(batch)

    @jax.jit
    def loss_and_grads(params, batch, z1, z2):
        (loss, _), grads = grad_fn(params, batch, z1, z2)
        return loss, grads

    @partial(jax.jit, static_argnames=("n",))
    def eval_step(params, data_key, z_key, epsilon, n: int = 1000):
        """Whole eval pass in one compiled program."""
        real = dataset.sample(data_key, n)
        z = sample_z(z_key, n, latent_dim, data_dim)
        z1, z2 = split_z(z, latent_dim)
        fake = model.apply(
            {"params": params}, z1, z2, epsilon, method=type(model).generate
        )
        x_hat, mu, logvar_e, eps_out = model.apply(
            {"params": params}, real, z1, z2
        )
        loss, dkl, mse = elbo_terms(real, x_hat, mu, logvar_e, eps_out)
        out = {
            "VAE Loss": loss,
            "KL divergence": dkl,
            "mse": mse,
            "_logvar_e": logvar_e,
            "_epsilon": eps_out,
        }
        if getattr(dataset, "score_on_host", False):
            # scoring needs host-only decompositions — hand the generated
            # batch back instead of fusing score() into the program
            out["_fake"] = fake
        else:
            out.update(dataset.score(fake))
        return out

    return StepFns(
        train_chunk=train_chunk,
        eval_loss=eval_loss,
        generate=generate,
        score=score,
        loss_and_grads=loss_and_grads,
        eval_step=eval_step,
    )


def make_epoch_chunk(model, dataset, tx: optax.GradientTransformation,
                     batch_size: int, mesh=None) -> Callable:
    """One FULL epoch as a single compiled program (epoch-mode datasets).

    The dataset array lives on device; the epoch is a scan over minibatch
    slices of an on-device shuffled permutation — the on-device replacement
    for the reference's torch-dataloader epoch loop
    (reference/model.py:176-193). Returns
    ``epoch_chunk(state, epoch, n_batches) -> (state, losses[n_batches])``.

    With ``mesh`` (a dp-axis Mesh), each minibatch is split over the data
    axis: every device takes its contiguous slice of the epoch permutation,
    draws its own reparameterization noise (per-device fold_in stream, like
    parallel/dp.py), and gradients are pmean'd across devices — params stay
    replicated and updates are identical on every device.
    """
    latent_dim = model.latent_dim
    data_dim = dataset.dimension
    # Corpus layout: store the corpus in the shape the first conv consumes
    # so the per-step gather emits conv-layout slabs directly and no
    # per-step relayout follows it. Values are identical either way
    # (reshape then take == take then reshape on axis 0), so losses are
    # unchanged.
    if hasattr(model, "image_hwc"):
        h, w, c = model.image_hwc
        corpus = dataset.images.reshape(dataset.images.shape[0], h, w, c)
    else:
        corpus = dataset.images.reshape(dataset.images.shape[0], -1)
    n_total = corpus.shape[0]

    grad_fn = make_elbo_grad_fn(model)

    if mesh is not None:
        dp = mesh.shape["dp"]
        dcn = mesh.shape.get("dp_dcn", 1)
        ndev = dp * dcn
        if batch_size % ndev != 0:
            raise ValueError(
                f"--batch_size {batch_size} must be divisible by dp={ndev}"
            )
        local_bs = batch_size // ndev

        def device_index():
            # linearized (dp_dcn, dp) index == the flat dp index over the
            # same device list (parallel/dp.py docstring)
            idx = jax.lax.axis_index("dp")
            if dcn > 1:
                idx = jax.lax.axis_index("dp_dcn") * dp + idx
            return idx

    def epoch_body(state: TrainState, epoch: jax.Array, n_batches: int):
        perm = jax.random.permutation(
            jax.random.fold_in(state.data_key, epoch), n_total
        )

        def get_batch(i):
            # clamp so the final iteration's prefetch stays in range (its
            # gather is discarded — ≤ one wasted minibatch DMA per epoch)
            i = jnp.minimum(i, n_batches - 1)
            if mesh is None:
                base = i * batch_size
                bs = batch_size
            else:
                base = i * batch_size + device_index() * local_bs
                bs = local_bs
            idx = jax.lax.dynamic_slice(perm, (base,), (bs,))
            return jnp.take(corpus, idx, axis=0)

        def body(carry, i):
            s, batch = carry
            # software pipeline: issue step i+1's corpus gather BEFORE this
            # step's compute — it has no dependency on the grads, so the
            # scheduler may overlap the gather with the conv stack. Data,
            # order, and RNG streams are IDENTICAL to the unpipelined loop.
            next_batch = get_batch(i + 1)
            if mesh is None:
                bs = batch_size
                kz = jax.random.fold_in(s.model_key, s.step)
            else:
                bs = local_bs
                kz = jax.random.fold_in(
                    jax.random.fold_in(s.model_key, s.step), device_index())
            z = sample_z(kz, bs, latent_dim, data_dim)
            z1, z2 = split_z(z, latent_dim)
            loss, grads = grad_fn(s.params, batch, z1, z2)
            if mesh is not None:
                # equal shards ⇒ mean-of-means is the global-batch mean;
                # hierarchical when two-level (within hosts, then across)
                grads = jax.lax.pmean(grads, "dp")
                loss = jax.lax.pmean(loss, "dp")
                if dcn > 1:
                    grads = jax.lax.pmean(grads, "dp_dcn")
                    loss = jax.lax.pmean(loss, "dp_dcn")
            updates, opt_state = tx.update(grads, s.opt_state, s.params)
            params = optax.apply_updates(s.params, updates)
            return (s.replace(params=params, opt_state=opt_state,
                              step=s.step + 1), next_batch), loss

        (state, _), losses = jax.lax.scan(
            body, (state, get_batch(jnp.asarray(0))), jnp.arange(n_batches))
        return state, losses

    @partial(jax.jit, static_argnames=("n_batches",), donate_argnames=("state",))
    def epoch_chunk(state: TrainState, epoch: jax.Array, n_batches: int):
        if mesh is None:
            return epoch_body(state, epoch, n_batches)
        from jax.sharding import PartitionSpec as P

        return jax.shard_map(
            partial(epoch_body, n_batches=n_batches),
            mesh=mesh,
            in_specs=(P(), P()),
            out_specs=(P(), P()),
            check_vma=False,  # outputs replicated by construction (pmean)
        )(state, epoch)

    return epoch_chunk
