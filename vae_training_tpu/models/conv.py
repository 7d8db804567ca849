"""Convolutional VAE for image datasets (BASELINE.json config 5).

Keeps the reference's VAE *semantics* — global learned posterior
log-variance ``epsilon_p`` (not amortized), optional tunable decoder
log-variance scalar, decoder output noise ``z2·e^{ε/2}`` added in both
training and sampling — but swaps the MLP encoder/decoder for conv stacks
sized for MNIST-scale images, with the ELBO computed over flattened pixels
(the reference flattens images before its FC VAE: reference/vae.py:124).

Encoder: 3×3 stride-2 SAME convolutions ``Conv{i}`` + ReLU, flatten, dense
``FCmu``. Decoder: dense ``FCin`` + ReLU, reshape, 3×3 stride-2 SAME
transposed convolutions ``Up{i}`` + ReLU, and ``UpOut`` to the image
channels. Kernels are HWIO, activations NHWC.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from .networks import LECUN_NORMAL, dense, dense_init, to_dot_precision

_DIMS = ("NHWC", "HWIO", "NHWC")


def _conv_init(key, cin: int, cout: int) -> dict:
    return {"kernel": LECUN_NORMAL(key, (3, 3, cin, cout), jnp.float32),
            "bias": jnp.zeros((cout,), jnp.float32)}


def _conv(p, x, precision):
    y = jax.lax.conv_general_dilated(
        x, p["kernel"], window_strides=(2, 2), padding="SAME",
        dimension_numbers=_DIMS, precision=precision)
    return y + p["bias"]


def _conv_transpose(p, x, precision):
    y = jax.lax.conv_transpose(
        x, p["kernel"], strides=(2, 2), padding="SAME",
        dimension_numbers=_DIMS, precision=precision)
    return y + p["bias"]


@dataclass(frozen=True)
class ConvVAE:
    """Conv VAE with the reference's latent/noise semantics.

    ``__call__`` consumes flattened pixel batches (B, H·W·C) like the MLP
    VAE so the training engine, ELBO, and stats paths are shared verbatim —
    or NHWC batches (B, H, W, C) directly, which the epoch program prefers
    (its corpus is stored in conv layout, see train/step.py
    make_epoch_chunk).
    """

    image_hwc: Tuple[int, int, int]
    latent_dim: int
    channels: Tuple[int, ...] = (32, 64)
    epsilon: float = 0.0
    tunable_decoder_var: bool = False
    dual_sigmoid_decoder: bool = False  # interface parity; unused for images
    matmul_precision: str = "bf16"  # --precision: "bf16" | "fp32"

    def __post_init__(self):
        h, w, _ = self.image_hwc
        n_up = len(self.channels)
        if h % (2 ** n_up) or w % (2 ** n_up):
            raise ValueError(
                f"image size {h}x{w} must be divisible by 2^{n_up}")

    @property
    def data_dim(self) -> int:
        h, w, c = self.image_hwc
        return h * w * c

    def _bottleneck(self) -> Tuple[int, int]:
        h, w, _ = self.image_hwc
        n_up = len(self.channels)
        return h // (2 ** n_up), w // (2 ** n_up)

    def init(self, key, x=None, z1=None, z2=None) -> dict:
        c = self.image_hwc[2]
        h0, w0 = self._bottleneck()
        dec_ch = tuple(reversed(self.channels))
        keys = iter(jax.random.split(key, 2 * len(self.channels) + 3))
        enc, cin = {}, c
        for i, ch in enumerate(self.channels):
            enc[f"Conv{i}"] = _conv_init(next(keys), cin, ch)
            cin = ch
        enc["FCmu"] = dense_init(next(keys), h0 * w0 * cin, self.latent_dim)
        dec = {"FCin": dense_init(next(keys), self.latent_dim,
                                  h0 * w0 * dec_ch[0])}
        cin = dec_ch[0]
        for i, ch in enumerate(dec_ch[1:], start=1):
            dec[f"Up{i}"] = _conv_init(next(keys), cin, ch)
            cin = ch
        dec["UpOut"] = _conv_init(next(keys), cin, c)
        params = {"Encoder": enc, "Decoder": dec,
                  "epsilon_p": jnp.ones((self.latent_dim,), jnp.float32)}
        if self.tunable_decoder_var:
            params["epsilon"] = jnp.ones((1,), jnp.float32)
        return {"params": params}

    def apply(self, variables, *args, method=None):
        """Run ``method`` (default: the training forward) with the params
        of ``variables``."""
        return (method or type(self).__call__)(self, variables["params"], *args)

    def encode(self, params, imgs):
        prec = to_dot_precision(self.matmul_precision)
        p = params["Encoder"]
        x = imgs
        for i in range(len(self.channels)):
            x = jax.nn.relu(_conv(p[f"Conv{i}"], x, prec))
        return dense(p["FCmu"], x.reshape(x.shape[0], -1), prec)

    def decode(self, params, z):
        prec = to_dot_precision(self.matmul_precision)
        p = params["Decoder"]
        h, w, c = self.image_hwc
        h0, w0 = self._bottleneck()
        x = jax.nn.relu(dense(p["FCin"], z, prec))
        x = x.reshape(z.shape[0], h0, w0, self.channels[-1])
        for i in range(1, len(self.channels)):
            x = jax.nn.relu(_conv_transpose(p[f"Up{i}"], x, prec))
        x = _conv_transpose(p["UpOut"], x, prec)
        return x.reshape(z.shape[0], h * w * c)

    def effective_epsilon(self, params):
        if self.tunable_decoder_var:
            return params["epsilon"] * self.epsilon
        return jnp.asarray(self.epsilon)

    def __call__(self, params, x, z1, z2):
        h, w, c = self.image_hwc
        imgs = x if x.ndim == 4 else x.reshape(x.shape[0], h, w, c)
        mu = self.encode(params, imgs)
        logvar_e = params["epsilon_p"]
        epsilon = self.effective_epsilon(params)
        samples = mu + jnp.exp(logvar_e / 2.0) * z1
        x_hat = self.decode(params, samples)
        x_hat = x_hat + z2 * jnp.exp(epsilon / 2.0)
        return x_hat, mu, logvar_e, epsilon

    def generate(self, params, z1, z2, epsilon):
        x_hat = self.decode(params, z1)
        return x_hat + z2 * jnp.exp(epsilon / 2.0)


def build_conv_vae(
    *,
    image_hwc: Tuple[int, int, int],
    latent_dim: int,
    channels_spec: str = "32|64",
    epsilon: float = 0.0,
    tunable_decoder_var: bool = False,
    precision: str = "bf16",
) -> ConvVAE:
    from .networks import parse_layer_sizes

    channels = parse_layer_sizes(channels_spec) or (32, 64)
    return ConvVAE(
        image_hwc=tuple(image_hwc),
        latent_dim=latent_dim,
        channels=tuple(channels),
        epsilon=epsilon,
        tunable_decoder_var=tunable_decoder_var,
        matmul_precision=precision,
    )
