"""The VAE with the reference's (legacy-semantics) architecture.

Re-implements the behavior of reference/networks.py:26-84 as plain
``jax.numpy`` functions over explicit parameter dicts. The semantics being
preserved (see SURVEY.md §7 "legacy-semantics traps"):

  - the encoder outputs the posterior *mean* only; the posterior
    log-variance is a single learned global vector ``epsilon_p`` (ones
    init), NOT an amortized per-input head (networks.py:67-72);
  - with ``tunable_decoder_var`` the decoder log-variance is
    ``param('epsilon', (1,), ones) * epsilon_const`` — a learned scalar
    *multiplying* the CLI ε (networks.py:70-71);
  - for the sigmoid dataset the decoder is a sum of a sigmoid-headed MLP
    and a plain MLP (networks.py:75-78);
  - decoder output noise ``z2 * exp(ε/2)`` is added in BOTH training and
    ancestral-sampling mode (networks.py:81-83);
  - sampling mode sets mu = logvar_e = 0 so the latent is exactly z1
    (networks.py:62-65).

Parameter names mirror the reference's module tree (Encoder/Decoder/
SigDecoder with FC{i} layers holding ``kernel`` (in, out) and ``bias``,
epsilon_p, epsilon) so exported state dicts are structurally comparable to
the reference's model.pkl. Models are immutable descriptions with the
``init(key, *example_inputs) -> {"params": ...}`` /
``apply(variables, *inputs, method=...)`` calling convention.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

# lecun-normal kernels (truncated normal, fan-in scaling), zero biases
LECUN_NORMAL = jax.nn.initializers.lecun_normal()


def to_dot_precision(spec: str) -> Optional[jax.lax.Precision]:
    """--precision value → the per-dot precision for the model's matmuls.

    ``bf16`` (default) → None: the backend's default for float32 dots, which
    on the H100 lets XLA run them in TF32 (10-bit mantissa operands, f32
    accumulation). ``fp32`` → ``Precision.HIGHEST``: true-fp32 matmuls.
    """
    return jax.lax.Precision.HIGHEST if spec == "fp32" else None


def dense_init(key, in_dim: int, out_dim: int, kernel_init=LECUN_NORMAL):
    return {"kernel": kernel_init(key, (in_dim, out_dim), jnp.float32),
            "bias": jnp.zeros((out_dim,), jnp.float32)}


def dense(p, x, precision=None):
    return jnp.dot(x, p["kernel"], precision=precision) + p["bias"]


def _batch_norm(p, stats, x, train: bool, momentum: float = 0.99,
                eps: float = 1e-5):
    """Batch normalisation over the batch axis; returns (y, new_stats)."""
    if train:
        mean, var = jnp.mean(x, axis=0), jnp.var(x, axis=0)
        stats = {"mean": momentum * stats["mean"] + (1 - momentum) * mean,
                 "var": momentum * stats["var"] + (1 - momentum) * var}
    else:
        mean, var = stats["mean"], stats["var"]
    y = (x - mean) * jax.lax.rsqrt(var + eps)
    return y * p["scale"] + p["bias"], stats


@dataclass(frozen=True)
class FullyConnectedNetwork:
    """Dense stack: ReLU (or leaky) between layers, none after the last.

    Behavioral port of reference/networks.py:26-47. ``features``
    includes the output dimension (the reference appends latent/data dim to
    the parsed pipe-string — reference/vae.py:53-54). An empty
    hidden-layer string therefore yields a single Dense layer: a pure
    linear map, which the linear/sigmoid sweeps rely on. With
    ``batch_norm`` the running statistics live in a ``batch_stats``
    collection that ``apply(..., mutable=["batch_stats"])`` returns updated.
    """

    features: Tuple[int, ...]
    sigmoid_head: bool = False
    leaky: bool = False
    batch_norm: bool = False
    unit_normal_init: bool = False  # reference's `datasets=True` kernel init
    matmul_precision: str = "bf16"  # --precision: "bf16" | "fp32"

    def init_params(self, key, in_dim: int) -> dict:
        kernel_init = (jax.nn.initializers.normal(1.0)
                       if self.unit_normal_init else LECUN_NORMAL)
        params, d = {}, in_dim
        for i, (k, size) in enumerate(
                zip(jax.random.split(key, len(self.features)), self.features)):
            params[f"FC{i}"] = dense_init(k, d, size, kernel_init)
            if self.batch_norm and i + 1 < len(self.features):
                params[f"BatchNorm_{i}"] = {"scale": jnp.ones((size,)),
                                            "bias": jnp.zeros((size,))}
            d = size
        return params

    def init_batch_stats(self) -> dict:
        return {f"BatchNorm_{i}": {"mean": jnp.zeros((size,)),
                                   "var": jnp.ones((size,))}
                for i, size in enumerate(self.features[:-1])}

    def __call__(self, params, x, batch_stats=None, train: bool = True):
        """Forward pass; returns (output, updated batch_stats or None)."""
        prec = to_dot_precision(self.matmul_precision)
        n = len(self.features)
        new_stats = {} if self.batch_norm else None
        for i in range(n):
            x = dense(params[f"FC{i}"], x, prec)
            if i + 1 < n:
                x = jax.nn.leaky_relu(x, 0.1) if self.leaky else jax.nn.relu(x)
                if self.batch_norm:
                    name = f"BatchNorm_{i}"
                    x, new_stats[name] = _batch_norm(
                        params[name], batch_stats[name], x, train)
        if self.sigmoid_head:
            x = jax.nn.sigmoid(x)
        return x, new_stats

    def init(self, key, x) -> dict:
        variables = {"params": self.init_params(key, x.shape[-1])}
        if self.batch_norm:
            variables["batch_stats"] = self.init_batch_stats()
        return variables

    def apply(self, variables, x, *, train: bool = True, mutable=()):
        out, stats = self(variables["params"], x,
                          variables.get("batch_stats"), train)
        if "batch_stats" in mutable:
            return out, {"batch_stats": stats}
        return out


@dataclass(frozen=True)
class VAE:
    """VAE with global posterior log-variance and optional dual decoder.

    ``encoder_features``/``decoder_features`` already include the final
    latent/data dimensions. ``epsilon`` is the CLI log-variance constant.
    ``dual_sigmoid_decoder`` enables the sigmoid-dataset decoder pair.
    """

    encoder_features: Tuple[int, ...]
    decoder_features: Tuple[int, ...]
    latent_dim: int
    epsilon: float = 0.0
    tunable_decoder_var: bool = False
    dual_sigmoid_decoder: bool = False
    matmul_precision: str = "bf16"  # --precision: "bf16" | "fp32"

    def _net(self, features, sigmoid_head=False) -> FullyConnectedNetwork:
        return FullyConnectedNetwork(tuple(features), sigmoid_head=sigmoid_head,
                                     matmul_precision=self.matmul_precision)

    def init(self, key, x, z1=None, z2=None) -> dict:
        data_dim = x.shape[-1]
        k_enc, k_dec, k_sig = jax.random.split(key, 3)
        params = {
            "Encoder": self._net(self.encoder_features).init_params(
                k_enc, data_dim),
            "Decoder": self._net(self.decoder_features).init_params(
                k_dec, self.latent_dim),
            # global posterior log-variance — ones init
            # (reference/networks.py:69)
            "epsilon_p": jnp.ones((self.latent_dim,), jnp.float32),
        }
        if self.dual_sigmoid_decoder:
            params["SigDecoder"] = self._net(
                self.decoder_features, sigmoid_head=True).init_params(
                    k_sig, self.latent_dim)
        if self.tunable_decoder_var:
            # learned scalar multiplying the ε constant
            # (reference/networks.py:70-71)
            params["epsilon"] = jnp.ones((1,), jnp.float32)
        return {"params": params}

    def apply(self, variables, *args, method=None):
        """Run ``method`` (default: the training forward) with the params
        of ``variables``."""
        return (method or type(self).__call__)(self, variables["params"], *args)

    def decode(self, params, samples):
        x_hat, _ = self._net(self.decoder_features)(params["Decoder"], samples)
        if self.dual_sigmoid_decoder:
            sig, _ = self._net(self.decoder_features, sigmoid_head=True)(
                params["SigDecoder"], samples)
            x_hat = sig + x_hat
        return x_hat

    def effective_epsilon(self, params):
        """Decoder log-variance: learned-scalar × constant, or the constant."""
        if self.tunable_decoder_var:
            return params["epsilon"] * self.epsilon
        return jnp.asarray(self.epsilon)

    def __call__(self, params, x, z1, z2):
        """Training-mode forward: returns (x_hat, mu, logvar_e, epsilon)."""
        mu, _ = self._net(self.encoder_features)(params["Encoder"], x)
        logvar_e = params["epsilon_p"]
        epsilon = self.effective_epsilon(params)
        samples = mu + jnp.exp(logvar_e / 2.0) * z1  # reparameterisation
        x_hat = self.decode(params, samples)
        x_hat = x_hat + z2 * jnp.exp(epsilon / 2.0)  # decoder output noise
        return x_hat, mu, logvar_e, epsilon

    def generate(self, params, z1, z2, epsilon):
        """Ancestral sampling: mu = logvar_e = 0 ⇒ latent is exactly z1.

        ``epsilon`` is supplied by the caller (the engine threads the
        current learned decoder log-variance — reference/vae.py:199).
        Output noise IS added, matching reference/networks.py:81-83.
        """
        x_hat = self.decode(params, z1)
        return x_hat + z2 * jnp.exp(epsilon / 2.0)


def parse_layer_sizes(spec: str) -> Tuple[int, ...]:
    """'512|512' → (512, 512); '' → () (pure linear model).

    Reference: reference/vae.py:53-54, reference/utils.py:313.
    """
    if spec == "":
        return ()
    return tuple(int(s) for s in spec.split("|"))


def build_vae(
    *,
    data_dim: int,
    latent_dim: int,
    encoder_layer_sizes: str = "",
    decoder_layer_sizes: str = "",
    epsilon: float = 0.0,
    tunable_decoder_var: bool = False,
    dataset_name: str | None = None,
    precision: str = "bf16",
) -> VAE:
    """Construct a VAE from the reference's CLI-level hyperparameters."""
    enc = parse_layer_sizes(encoder_layer_sizes) + (latent_dim,)
    dec = parse_layer_sizes(decoder_layer_sizes) + (data_dim,)
    return VAE(
        encoder_features=enc,
        decoder_features=dec,
        latent_dim=latent_dim,
        epsilon=epsilon,
        tunable_decoder_var=tunable_decoder_var,
        dual_sigmoid_decoder=(dataset_name == "sigmoid"),
        matmul_precision=precision,
    )
