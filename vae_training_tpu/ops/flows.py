"""Invertible-flow building blocks (library surface parity with C15).

The reference ships flow-model helper ops that its live VAE path never
exercises but that form its library surface (reference/utils.py:41-43,
140-310): an invertible BatchNorm with a cross-device moment-reduction hook,
its inverse, invertible dense, coupling-layer masks, and 2×2 space-to-depth.
Rebuilt here on linen with the same semantics; the cross-device hook takes a
mesh axis name and reduces moments with ``lax.pmean`` over ICI (usable under
``shard_map``), exactly the pattern the reference sketched with pmap axis
names (utils.py:215-221).
"""

from __future__ import annotations

from typing import Any, Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax import lax


class Constants:
    """Hyperparameter constants (reference/utils.py:15-22)."""

    lambd = 10
    alpha = 0.1
    epsilon_singular_value = 1e-7


def leaky_relu(x):
    return jnp.maximum(x, x * Constants.alpha)


def inv_leaky_relu(x):
    return jnp.minimum(x, x / Constants.alpha)


def inv_dense(x, weight, bias):
    """Invert y = x·W + b (reference/utils.py:41-43)."""
    return jnp.dot(x - bias, jnp.linalg.inv(weight))


class InvertibleBatchNorm(nn.Module):
    """BatchNorm that records the exact (mul, mean) used per call so the
    transform can be inverted; batch moments optionally pmean'd across a
    mesh axis. Reference: reference/utils.py:140-242.

    State collection ``batch_stats``: mean/var running averages plus
    recent_mul/recent_mean (the per-call affine actually applied).
    """

    axis: int = -1
    momentum: float = 0.99
    epsilon: float = 1e-5
    use_bias: bool = True
    use_scale: bool = True
    axis_name: Optional[str] = None
    axis_index_groups: Any = None

    @nn.compact
    def __call__(self, x, use_running_average: bool = False):
        x = jnp.asarray(x, jnp.float32)
        feat_axes = (self.axis % x.ndim,)
        feature_shape = tuple(
            d if i in feat_axes else 1 for i, d in enumerate(x.shape)
        )
        reduced_shape = tuple(d for i, d in enumerate(x.shape) if i in feat_axes)
        reduction_axes = tuple(i for i in range(x.ndim) if i not in feat_axes)

        initializing = self.is_initializing()
        ra_mean = self.variable(
            "batch_stats", "mean", lambda: jnp.zeros(reduced_shape))
        ra_var = self.variable(
            "batch_stats", "var", lambda: jnp.ones(reduced_shape))
        recent_mul = self.variable(
            "batch_stats", "recent_mul", lambda: jnp.ones(reduced_shape))
        recent_mean = self.variable(
            "batch_stats", "recent_mean", lambda: jnp.zeros(feature_shape))

        if use_running_average:
            mean, var = ra_mean.value, ra_var.value
        else:
            mean = jnp.mean(x, axis=reduction_axes)
            mean2 = jnp.mean(lax.square(x), axis=reduction_axes)
            if self.axis_name is not None and not initializing:
                # Cross-device moment reduction over the mesh axis (ICI).
                stacked = jnp.concatenate([mean, mean2])
                mean, mean2 = jnp.split(
                    lax.pmean(stacked, axis_name=self.axis_name,
                              axis_index_groups=self.axis_index_groups), 2)
            var = mean2 - lax.square(mean)
            if not initializing:
                ra_mean.value = (self.momentum * ra_mean.value
                                 + (1 - self.momentum) * mean)
                ra_var.value = (self.momentum * ra_var.value
                                + (1 - self.momentum) * var)

        mean_b = mean.reshape(feature_shape)
        y = x - mean_b
        mul = lax.rsqrt(var + self.epsilon)
        if not initializing:
            recent_mean.value = mean_b
            recent_mul.value = mul
        mul_b = mul.reshape(feature_shape)
        if self.use_scale:
            mul_b = mul_b * self.param(
                "scale", nn.initializers.ones, reduced_shape
            ).reshape(feature_shape)
        y = y * mul_b
        if self.use_bias:
            y = y + self.param(
                "bias", nn.initializers.zeros, reduced_shape
            ).reshape(feature_shape)
        return y


def inv_batch_norm(y, params, batch_stats, use_bias=True, use_scale=True):
    """Invert InvertibleBatchNorm given its params + recorded stats.

    Reference: reference/utils.py:245-261.
    """
    mul = batch_stats["recent_mul"]
    mean = batch_stats["recent_mean"]
    if use_bias:
        y = y - params["bias"]
    y = y / mul
    if use_scale:
        y = y / params["scale"]
    return y + mean


def get_mask(shape, reverse: bool, use_checkerboard: bool = True):
    """Coupling-layer masks: checkerboard or channel-split.

    Reference: reference/utils.py:264-291. ``shape`` is (H, W, C) or
    (B, H, W, C).
    """
    height, width, channels = shape[-3], shape[-2], shape[-1]
    if use_checkerboard:
        rows = jax.lax.broadcasted_iota(jnp.int32, (height, width), 0)
        cols = jax.lax.broadcasted_iota(jnp.int32, (height, width), 1)
        mask = ((rows % 2 + cols) % 2).astype(jnp.float32).reshape(
            height, width, 1)
        if reverse:
            mask = 1.0 - mask
    else:
        half = channels // 2
        zero = jnp.zeros((height, width, half))
        one = jnp.ones((height, width, half))
        mask = (jnp.concatenate([zero, one], axis=-1) if reverse
                else jnp.concatenate([one, zero], axis=-1))
    if len(shape) == 4:
        return mask[jnp.newaxis, ...]
    return mask


def squeeze_2x2(x, reverse: bool = False):
    """2×2 space-to-depth (and its inverse) for multi-scale flows.

    Reference: reference/utils.py:294-310.
    """
    if x.ndim != 4:
        raise ValueError("expected (B, H, W, C)")
    b, h, w, c = x.shape
    if reverse:
        if c % 4 != 0:
            raise ValueError(f"Number of channels {c} is not divisible by 4")
        x = x.reshape(b, h, w, c // 4, 2, 2)
        x = jnp.transpose(x, (0, 1, 4, 2, 5, 3))
        return x.reshape(b, 2 * h, 2 * w, c // 4)
    if h % 2 != 0 or w % 2 != 0:
        raise ValueError(f"Expected even spatial dims HxW got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = jnp.transpose(x, (0, 1, 3, 5, 2, 4))
    return x.reshape(b, h // 2, w // 2, c * 4)


@jax.jit
@jax.vmap
def cross_entropy_loss(logits, label):
    """Reference: reference/utils.py:68-71."""
    return -logits[label]


@jax.jit
def compute_accuracy(logits, labels):
    """Reference: reference/utils.py:74-76."""
    return jnp.mean(jnp.argmax(logits, -1) == labels)
