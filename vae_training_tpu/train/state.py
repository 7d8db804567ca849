"""Training state: one pytree carrying everything the fused step mutates.

Replaces the reference's scattered mutable host state (optimizer, model,
python-side PRNG key chains — reference/model.py:29-34,57-59,
reference/vae.py:112-129) with a single immutable pytree that lives on
device and is threaded through ``lax.scan``. PRNG: per-step keys are derived
by ``fold_in(base_key, step)`` so a scan chunk needs no host key splits.
"""

from __future__ import annotations

from typing import Any

import jax
import optax

from ..utils.pytree import PyTreeNode

# The framework's Adam hyperparameters (reference flax.optim.Adam defaults —
# reference/vae.py:113). Optimizer construction goes through
# make_adam() so every trainer shares them.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8


def make_adam(learning_rate: float,
              adam_dtype: str = "f32") -> optax.GradientTransformation:
    """The framework's optimizer. ``adam_dtype="bf16"`` stores the moments
    of every WEIGHT MATRIX (ndim>=2 leaf) in bfloat16 — compute stays f32 —
    halving the optimizer state's memory and its per-step read/write
    traffic. 1-D leaves (biases, epsilon_p, epsilon) keep f32 moments.

    Rounding contract: each step computes m/v in f32, rounds to bf16
    (round-to-nearest-even), and uses the ROUNDED values for the parameter
    update, so the trajectory does not depend on how steps are chunked."""
    if adam_dtype == "f32":
        return optax.adam(learning_rate, b1=ADAM_B1, b2=ADAM_B2, eps=ADAM_EPS)
    if adam_dtype != "bf16":
        raise ValueError(f"adam_dtype must be f32|bf16, got {adam_dtype!r}")
    return optax.chain(_scale_by_adam_bf16(), optax.scale(-learning_rate))


def _moment_dtype(p) -> Any:
    import jax.numpy as jnp

    return jnp.bfloat16 if p.ndim >= 2 else p.dtype


def _scale_by_adam_bf16() -> optax.GradientTransformation:
    """optax.scale_by_adam with bfloat16 moment STORAGE for ndim>=2 leaves.

    Reuses optax.ScaleByAdamState so every state introspection in the repo
    (model.pkl export, tp sharding, checkpointing) works unchanged. Update math is
    optax's: mhat/(sqrt(vhat)+eps) with bias corrections 1-beta^t, computed
    in f32 FROM THE ROUNDED moments (see make_adam docstring)."""
    import jax.numpy as jnp

    def init(params):
        zeros = lambda p: jnp.zeros(p.shape, _moment_dtype(p))
        return optax.ScaleByAdamState(
            count=jnp.zeros([], jnp.int32),
            mu=jax.tree_util.tree_map(zeros, params),
            nu=jax.tree_util.tree_map(zeros, params),
        )

    def update(updates, state, params=None):
        del params
        count = optax.safe_increment(state.count)

        def new_mu(m, g):
            m32 = ADAM_B1 * m.astype(jnp.float32) + (1.0 - ADAM_B1) * g
            return m32.astype(m.dtype)

        def new_nu(v, g):
            v32 = ADAM_B2 * v.astype(jnp.float32) + (1.0 - ADAM_B2) * g * g
            return v32.astype(v.dtype)

        mu = jax.tree_util.tree_map(new_mu, state.mu, updates)
        nu = jax.tree_util.tree_map(new_nu, state.nu, updates)
        t = count.astype(jnp.float32)
        bc1 = 1.0 - ADAM_B1 ** t
        bc2 = 1.0 - ADAM_B2 ** t

        def upd(m, v):
            mh = m.astype(jnp.float32) / bc1
            vh = v.astype(jnp.float32) / bc2
            return mh / (jnp.sqrt(vh) + ADAM_EPS)

        out = jax.tree_util.tree_map(upd, mu, nu)
        return out, optax.ScaleByAdamState(count=count, mu=mu, nu=nu)

    return optax.GradientTransformation(init, update)


def adam_state(opt_state) -> optax.ScaleByAdamState:
    """The ScaleByAdamState inside an optax state (possibly chained)."""
    for s in jax.tree_util.tree_leaves(
            opt_state,
            is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(s, optax.ScaleByAdamState):
            return s
    raise ValueError("opt_state does not contain a ScaleByAdamState")


class TrainState(PyTreeNode):
    params: Any
    opt_state: Any
    step: jax.Array  # int32 scalar
    model_key: jax.Array  # base key for reparameterisation noise z
    data_key: jax.Array  # base key for on-device batch sampling

    @classmethod
    def create(cls, *, params, tx: optax.GradientTransformation, model_key, data_key):
        import jax.numpy as jnp

        return cls(
            params=params,
            opt_state=tx.init(params),
            step=jnp.asarray(0, jnp.int32),
            model_key=model_key,
            data_key=data_key,
        )
