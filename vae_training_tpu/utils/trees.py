"""Pytree math utilities.

``correlation_ratio`` generalizes the reference's hand-rolled per-parameter
landscape diagnostic (reference/vae.py:143-179) to arbitrary pytrees:

    ratio = -⟨∇loss(θ), θ* − θ⟩ / ‖θ* − θ‖²

measuring how well the negative gradient at θ points toward the final
parameters θ*. (The reference flips the sign on its 'epsilon' term —
vae.py:171 — in a code path that never executes; we use the consistent
formula for every leaf.)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def tree_vdot(a, b) -> jax.Array:
    leaves = jax.tree_util.tree_map(
        lambda x, y: jnp.vdot(x.astype(jnp.float32), y.astype(jnp.float32)), a, b
    )
    return jax.tree_util.tree_reduce(jnp.add, leaves, jnp.float32(0.0))


def tree_sq_norm(a) -> jax.Array:
    return tree_vdot(a, a)


def correlation_ratio(opt_params, params, grads) -> jax.Array:
    """Whole-tree ratio: sums the per-leaf inner products and squared norms
    before dividing — exactly the reference's accumulation structure
    (reference/vae.py:144-179 accumulates ``inner_product`` and
    ``squared_norm`` across its hand-enumerated leaves and divides once)."""
    displacement = jax.tree_util.tree_map(
        lambda o, p: o - p, opt_params, params
    )
    inner = -tree_vdot(grads, displacement)
    return inner / tree_sq_norm(displacement)


def correlation_ratio_per_param(opt_params, params, grads) -> dict:
    """Per-parameter ratios: one ``-⟨∇loss, θ*−θ⟩ / ‖θ*−θ‖²`` for EACH leaf
    (kernel/bias/epsilon/epsilon_p), keyed by its slash-joined param path —
    the per-parameter granularity of the reference's hand-rolled diagnostic,
    which computes a separate displacement and inner product for every leaf
    (reference/vae.py:149-177) before accumulating. Zero-displacement
    leaves yield NaN (0/0), matching the formula.
    """
    out = {}
    flat_p = dict(jax.tree_util.tree_leaves_with_path(params))
    flat_g = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, opt_leaf in jax.tree_util.tree_leaves_with_path(opt_params):
        d = (jnp.asarray(opt_leaf) - jnp.asarray(flat_p[path])).astype(
            jnp.float32
        )
        g = jnp.asarray(flat_g[path]).astype(jnp.float32)
        key = "/".join(
            str(getattr(k, "key", getattr(k, "idx", k))) for k in path
        )
        out[key] = -jnp.vdot(g, d) / jnp.vdot(d, d)
    return out


def sin_theta_distance(A: jnp.ndarray, B: jnp.ndarray) -> jax.Array:
    """Sin-theta subspace distance between (column spaces of) A and B.

    Reference: reference/utils.py:317-325 (assumes orthogonal inputs).

    The SVDs of these small matrices run on HOST numpy (one-off analysis
    math); inputs are fetched, the result returns as a jax scalar, so the
    jnp-facing signature is unchanged. Not jit-traceable by design.
    """
    import numpy as np

    U, _, _ = np.linalg.svd(np.asarray(jax.device_get(A)))
    Up, _, _ = np.linalg.svd(np.asarray(jax.device_get(B)))
    return jnp.asarray(0.5 * np.linalg.norm(U - Up, ord="fro"))
