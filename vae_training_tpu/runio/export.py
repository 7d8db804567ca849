"""model.pkl export in the reference's optimizer-state-dict layout.

The reference persists its optimizer's flax state dict via pickle
(reference/model.py:85-89), i.e. a nested dict:

    {"target": <param tree: {"Decoder": ..., "Encoder": ..., "epsilon_p"...}>,
     "state": {"step": int,
               "param_states": <per-param {"grad_ema", "grad_sq_ema"}>}}

``target`` is the RAW param tree — the reference's pre-Linen model
serializes as its params with no "params" wrapper (the reference indexes
``initial_params['Decoder']`` directly, reference/vae.py:87-105). We
emit the same layout, as plain dicts of numpy arrays, from optax's Adam
state so downstream analysis written against reference artifacts keeps
working, and can load it back (making the reference's dead
``--state_dict`` flag real — SURVEY.md §3.5).
``load_model_pkl`` also accepts this repo's pre-round-2 exports, which
wrapped ``target`` in a ``{"params": ...}`` level.
"""

from __future__ import annotations

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax


def to_reference_state_dict(params, opt_state) -> dict:
    from ..train.state import adam_state

    adam = adam_state(opt_state)
    param_states = jax.tree_util.tree_map(
        lambda m, v: {"grad_ema": np.asarray(m), "grad_sq_ema": np.asarray(v)},
        adam.mu, adam.nu)
    return {
        "target": jax.tree_util.tree_map(np.asarray, params),
        "state": {
            "step": int(adam.count),
            "param_states": param_states,
        },
    }


def _restore_like(template, state_dict):
    """``state_dict``'s arrays in ``template``'s tree structure (raises
    ValueError when the two trees differ)."""
    return jax.tree_util.tree_map(lambda _, v: np.asarray(v), template,
                                  state_dict)


def save_model_pkl(path: str, params, opt_state) -> None:
    with open(path, "wb") as f:
        pickle.dump(to_reference_state_dict(params, opt_state), f)


def load_model_pkl(path: str, params_template, opt_state_template):
    """Restore (params, opt_state) from a model.pkl state dict.

    Accepts both this framework's exports and structurally-matching
    reference artifacts (same param tree shape).
    """
    from ..train.state import adam_state

    with open(path, "rb") as f:
        sd = pickle.load(f)
    target_sd = sd["target"]
    if isinstance(target_sd, dict) and set(target_sd) == {"params"}:
        # this repo's pre-round-2 exports wrapped the tree one level deep
        target_sd = target_sd["params"]
    params = _restore_like(params_template, target_sd)
    template = adam_state(opt_state_template)
    mu_t, nu_t = template.mu, template.nu
    flat_ps = sd["state"]["param_states"]
    is_moments = lambda x: isinstance(x, dict) and "grad_ema" in x
    mu = _restore_like(mu_t, jax.tree_util.tree_map(
        lambda d: d["grad_ema"], flat_ps, is_leaf=is_moments))
    nu = _restore_like(nu_t, jax.tree_util.tree_map(
        lambda d: d["grad_sq_ema"], flat_ps, is_leaf=is_moments))
    count = jnp.asarray(sd["state"]["step"], jnp.int32)

    def rebuild(s):
        if isinstance(s, optax.ScaleByAdamState):
            return optax.ScaleByAdamState(count=count, mu=mu, nu=nu)
        return s

    opt_state = jax.tree_util.tree_map(
        rebuild,
        opt_state_template,
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState),
    )
    return params, opt_state
