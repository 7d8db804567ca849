"""Warm-start analytic initializers.

Re-implements the reference's parameter surgery (reference/vae.py:62-107)
as pure functions over linen param trees. The reference mutates the raw param
dict in place; here we return a new tree (params are immutable pytrees).

The *means* of the initializations match the reference's formulas exactly;
perturbation draws use properly split keys (the reference reuses one key for
every draw — reference/vae.py:72-79 — which we do not copy since the
perturbations are i.i.d. noise either way).

Both initializers only make sense for 0-hidden-layer (pure linear)
encoder/decoders, like the reference (they index FC0 kernels directly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def warm_start_sigmoid(params: dict, dataset, latent_dim: int, key: jax.Array) -> dict:
    """Identity encoder/decoder restricted to the manifold dimensions.

    Requires latent_dim == ambient dimension (reference/vae.py:64).
    The decoder/encoder kernels start as the identity with the block acting
    on padding dimensions zeroed; the posterior log-variance starts at 0 on
    manifold dims and -3 on padding dims (reference/vae.py:65-80).
    """
    data_dim = dataset.dimension
    if latent_dim != data_dim:
        raise ValueError(
            "sigmoid warm start requires latent_dim == dataset dimension "
            f"(got {latent_dim} vs {data_dim})"
        )
    cut = dataset.dim + 1  # manifold coords: z (dim) + sigma coordinate
    eye = jnp.eye(latent_dim)
    blocked_eye = eye.at[cut:, cut:].set(0.0)

    k_dec, k_sig, k_epsp, k_enc = jax.random.split(key, 4)

    dec = blocked_eye + 0.1 * jax.random.normal(k_dec, (latent_dim, data_dim))
    sig_dec = 0.1 * jax.random.normal(k_sig, (latent_dim, data_dim))
    enc = blocked_eye + 0.1 * jax.random.normal(k_enc, (data_dim, latent_dim))
    eps_p = (
        jnp.zeros((latent_dim,)).at[cut:].set(-3.0)
        + 0.1 * jax.random.normal(k_epsp, (latent_dim,))
    )

    new = dict(params)
    new["Decoder"] = {**params["Decoder"], "FC0": {**params["Decoder"]["FC0"], "kernel": dec}}
    new["SigDecoder"] = {
        **params["SigDecoder"],
        "FC0": {**params["SigDecoder"]["FC0"], "kernel": sig_dec},
    }
    new["Encoder"] = {**params["Encoder"], "FC0": {**params["Encoder"]["FC0"], "kernel": enc}}
    new["epsilon_p"] = eps_p
    return new


def warm_start_linear_gaussian(
    params: dict,
    dataset,
    latent_dim: int,
    latent_off_dimension: int,
    key: jax.Array,
    pinv=None,
) -> dict:
    """Decoder ← [A | extra | 0] (plus padding rows), encoder ← pinv(A).

    Reference: reference/vae.py:82-107. ``latent_off_dimension`` extra
    random decoder columns model "off-manifold" latent directions; the
    posterior log-variance starts at -3 on the first
    intrinsic+off dimensions (active latents) and 0 elsewhere.
    """
    data_dim = dataset.dimension
    if not dataset.dim + latent_off_dimension < latent_dim:
        raise ValueError(
            "linear warm start requires dataset dim + latent_off_dimension "
            f"< latent_dim (got {dataset.dim} + {latent_off_dimension} vs "
            f"{latent_dim})"
        )
    A = dataset.A  # (dim, intrinsic_dim)
    intrinsic = A.shape[1]

    k_extra, k_dec, k_enc, k_epsp = jax.random.split(key, 4)

    extra = jax.random.normal(k_extra, (dataset.dim, latent_off_dimension))
    zero_cols = jnp.zeros((dataset.dim, latent_dim - dataset.dim - latent_off_dimension))
    dec_top = jnp.concatenate([A, extra, zero_cols], axis=1)
    # Width is latent_dim + (intrinsic - dim); equal widths require
    # intrinsic == dim, same as the reference's implicit precondition.
    if dec_top.shape[1] != latent_dim:
        raise ValueError(
            "linear warm start requires intrinsic dimension == dataset "
            f"dimension (A has {intrinsic} columns, dataset dim {dataset.dim})"
        )
    dec_pad_rows = jnp.zeros((data_dim - dataset.dim, latent_dim))
    dec_const = jnp.concatenate([dec_top, dec_pad_rows], axis=0)  # (data, latent)
    dec_const = dec_const + 0.01 * jax.random.normal(k_dec, (data_dim, latent_dim))

    # Host-side pinv: one-time init math on a tiny matrix.
    # Jitted callers (the grid trainer) precompute it per row and pass it
    # in, since np.asarray(A) on a traced A is impossible.
    if pinv is None:
        pinv = np.linalg.pinv(np.asarray(A))
    enc_const = jnp.asarray(pinv)  # (intrinsic, dim)
    enc_zero_rows = jnp.zeros((latent_dim - intrinsic, dataset.dim))
    enc_zero_cols = jnp.zeros((latent_dim, data_dim - dataset.dim))
    enc_const = jnp.concatenate([enc_const, enc_zero_rows], axis=0)
    enc_const = jnp.concatenate([enc_const, enc_zero_cols], axis=1)  # (latent, data)
    enc_const = enc_const + 0.01 * jax.random.normal(k_enc, (latent_dim, data_dim))

    eps_p = (
        jnp.zeros((latent_dim,)).at[: intrinsic + latent_off_dimension].set(-3.0)
        + 0.1 * jax.random.normal(k_epsp, (latent_dim,))
    )

    new = dict(params)
    # linen Dense kernels are (in, out): decoder (latent, data) = dec_const.T,
    # encoder (data, latent) = enc_const.T — matching vae.py:91,100.
    new["Decoder"] = {
        **params["Decoder"],
        "FC0": {**params["Decoder"]["FC0"], "kernel": dec_const.T},
    }
    new["Encoder"] = {
        **params["Encoder"],
        "FC0": {**params["Encoder"]["FC0"], "kernel": enc_const.T},
    }
    new["epsilon_p"] = eps_p
    return new


def apply_warm_start(
    params: dict,
    dataset_name: str,
    dataset,
    latent_dim: int,
    latent_off_dimension: int,
    key: jax.Array,
    pinv=None,
) -> dict:
    if dataset_name == "sigmoid":
        return warm_start_sigmoid(params, dataset, latent_dim, key)
    if dataset_name == "linear_gaussian":
        return warm_start_linear_gaussian(
            params, dataset, latent_dim, latent_off_dimension, key, pinv=pinv
        )
    return params
