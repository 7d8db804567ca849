"""Closed-form gaussian ELBO decomposition.

Pure functions factored out of the reference's jitted ``train_step``/``loss``
bodies (reference/networks.py:87-113) so the same math backs the
train step and the eval path.

Semantics preserved exactly:
  - ``epsilon`` is a *log-variance*; decoder output stdev is exp(ε/2)
    (reference/networks.py:81,95).
  - the posterior log-variance ``logvar_e`` is a global learned vector
    (input-independent), broadcast across the batch
    (reference/networks.py:69,72).
  - the reconstruction term includes the gaussian normalisation constant
    0.5·(log 2π + ε) per output dimension (reference/networks.py:96).
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp

# host math, NOT jnp: a module-level device op would initialize the JAX
# backend at import time, freezing platform selection (JAX_PLATFORMS) for
# whoever imports this module
LOG_2PI = math.log(2.0 * math.pi)
EPS = 1e-8


@jax.vmap
def binary_cross_entropy(probs: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Per-sample summed BCE (library-surface parity with
    reference/networks.py:16-18; unused by the live ELBO)."""
    return -jnp.sum(
        labels * jnp.log(probs + EPS) + (1 - labels) * jnp.log(1 - probs + EPS)
    )


def fill_diagonal(a: jnp.ndarray, val) -> jnp.ndarray:
    """Set the leading diagonal of the trailing 2 dims.

    Reference: reference/networks.py:20-23.
    """
    if a.ndim < 2:
        raise ValueError("fill_diagonal needs ndim >= 2")
    i, j = jnp.diag_indices(min(a.shape[-2:]))
    return a.at[..., i, j].set(val)


def kl_to_standard_normal(mu: jnp.ndarray, logvar_e: jnp.ndarray) -> jnp.ndarray:
    """KL(N(mu, diag e^logvar) || N(0, I)), summed over latent dims.

    Reference: reference/networks.py:94.
    """
    return -0.5 * jnp.sum(
        1.0 + logvar_e - jnp.exp(logvar_e) - jnp.square(mu), axis=-1
    )


def gaussian_nll(
    x: jnp.ndarray, x_hat: jnp.ndarray, epsilon: jnp.ndarray
) -> jnp.ndarray:
    """Per-sample gaussian negative log-likelihood with log-variance ε.

    Reference: reference/networks.py:96 (the "mse" channel).
    """
    var_d = jnp.exp(epsilon)
    per_dim = 0.5 * jnp.square(x_hat - x) / var_d + 0.5 * (LOG_2PI + epsilon)
    return jnp.sum(per_dim, axis=-1)


def elbo_terms(
    x: jnp.ndarray,
    x_hat: jnp.ndarray,
    mu: jnp.ndarray,
    logvar_e: jnp.ndarray,
    epsilon: jnp.ndarray,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(negative-ELBO mean, KL mean, reconstruction-NLL mean).

    ``loss = mean_i(Dkl_i + mse_i)`` — reference/networks.py:97-98.
    """
    dkl = kl_to_standard_normal(mu, logvar_e)
    mse = gaussian_nll(x, x_hat, epsilon)
    loss = jnp.mean(dkl + mse)
    return loss, jnp.mean(dkl), jnp.mean(mse)
