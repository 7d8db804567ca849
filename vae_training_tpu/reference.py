"""Plain float32 reference of one training step: loss, gradients, Adam.

An independent restatement of the reference program's math
(reference/networks.py:26-113, flax.optim.Adam), written against
explicit parameter dicts in the package's layout (``Encoder``/``Decoder``/
``SigDecoder`` stacks of ``FC{i}`` ``kernel``/``bias``, or the conv VAE's
``Conv{i}``/``FCmu``/``FCin``/``Up{i}``/``UpOut``; ``epsilon_p``;
``epsilon``). It shares no code with ``models/`` or ``train/``, and every
dot and convolution runs at ``Precision.HIGHEST``, so it is the yardstick
the compiled step is compared with (tests/test_reference_step.py and
chip_smoke.py).

Semantics: the encoder gives the posterior mean; the posterior
log-variance is the global vector ``epsilon_p``; the decoder log-variance
is ``epsilon * eps_const`` (learned scalar) or ``eps_const``; the sigmoid
dataset's decoder is a sigmoid-headed stack plus a plain stack; decoder
output noise ``z2 * exp(eps/2)`` is added; the loss is the batch mean of
KL(q || N(0, I)) plus the gaussian negative log-likelihood with its
normalising constant.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


class Spec(NamedTuple):
    """What the reference needs beyond the params: the CLI's ε constant,
    whether ε is learned (-tdv), the sigmoid dual decoder, and for the conv
    VAE the image shape (H, W, C)."""

    eps_const: float
    tunable: bool
    dual: bool = False
    image_hwc: Optional[Tuple[int, int, int]] = None


def _mlp(layers: dict, x, sigmoid_head: bool = False):
    n = len(layers)
    for i in range(n):
        x = jnp.matmul(x, layers[f"FC{i}"]["kernel"], precision=HIGHEST) \
            + layers[f"FC{i}"]["bias"]
        if i < n - 1:
            x = jnp.maximum(x, 0.0)
    return 1.0 / (1.0 + jnp.exp(-x)) if sigmoid_head else x


def _conv_down(p, x):
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=HIGHEST)
    return y + p["bias"]


def _conv_up(p, x):
    y = jax.lax.conv_transpose(
        x, p["kernel"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=HIGHEST)
    return y + p["bias"]


def _dense(p, x):
    return jnp.matmul(x, p["kernel"], precision=HIGHEST) + p["bias"]


def _conv_encode(enc: dict, imgs):
    x = imgs
    i = 0
    while f"Conv{i}" in enc:
        x = jnp.maximum(_conv_down(enc[f"Conv{i}"], x), 0.0)
        i += 1
    return _dense(enc["FCmu"], x.reshape(x.shape[0], -1))


def _conv_decode(dec: dict, z, image_hwc):
    h, w, c = image_hwc
    n_up = sum(k.startswith("Up") for k in dec)  # Up{i}... plus UpOut
    ch0 = dec["FCin"]["kernel"].shape[1] // ((h >> n_up) * (w >> n_up))
    x = jnp.maximum(_dense(dec["FCin"], z), 0.0)
    x = x.reshape(z.shape[0], h >> n_up, w >> n_up, ch0)
    for i in range(1, n_up):
        x = jnp.maximum(_conv_up(dec[f"Up{i}"], x), 0.0)
    return _conv_up(dec["UpOut"], x).reshape(z.shape[0], h * w * c)


def loss(spec: Spec, params: dict, x, z1, z2):
    """Negative ELBO, averaged over the batch."""
    eps = (params["epsilon"][0] * spec.eps_const if spec.tunable
           else jnp.float32(spec.eps_const))
    logvar_e = params["epsilon_p"]
    if spec.image_hwc is None:
        mu = _mlp(params["Encoder"], x)
        decode = lambda s: _mlp(params["Decoder"], s)
    else:
        mu = _conv_encode(params["Encoder"], x.reshape(-1, *spec.image_hwc))
        decode = lambda s: _conv_decode(params["Decoder"], s, spec.image_hwc)
    s = mu + jnp.exp(logvar_e / 2.0) * z1
    x_hat = decode(s)
    if spec.dual:
        x_hat = x_hat + _mlp(params["SigDecoder"], s, sigmoid_head=True)
    x_hat = x_hat + z2 * jnp.exp(eps / 2.0)
    kl = -0.5 * jnp.sum(1.0 + logvar_e - jnp.exp(logvar_e) - mu ** 2, axis=1)
    nll = jnp.sum(0.5 * (x_hat - x) ** 2 / jnp.exp(eps)
                  + 0.5 * (math.log(2.0 * math.pi) + eps), axis=1)
    return jnp.mean(kl + nll)


def adam(params, grads, m, v, t: int, lr: float, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8):
    """One Adam step (bias-corrected, ε outside the root); ``t`` counts
    from 1. Returns (params, m, v)."""
    m = jax.tree_util.tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, m, grads)
    v = jax.tree_util.tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g,
                               v, grads)
    new = jax.tree_util.tree_map(
        lambda p, m_, v_: p - lr * (m_ / (1 - b1 ** t))
        / (jnp.sqrt(v_ / (1 - b2 ** t)) + eps), params, m, v)
    return new, m, v


def step(spec: Spec, params: dict, x, z1, z2, lr: float):
    """The first training step from fresh Adam moments: (loss, grads,
    updated params)."""
    value, grads = jax.value_and_grad(lambda p: loss(spec, p, x, z1, z2))(
        params)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    new_params, _, _ = adam(params, grads, zeros, zeros, 1, lr)
    return value, grads, new_params


def rel_err(got, want) -> float:
    """Largest per-leaf relative error ‖got − want‖ / ‖want‖ over two
    pytrees of the same structure (a leaf whose reference is all zeros is
    compared by its absolute error)."""
    import numpy as np

    worst = 0.0
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        g = np.asarray(g, np.float64)
        w = np.asarray(w, np.float64)
        scale = np.linalg.norm(w)
        err = np.linalg.norm(g - w) / (scale if scale > 0 else 1.0)
        worst = max(worst, float(err))
    return worst
