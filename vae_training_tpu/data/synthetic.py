"""Synthetic manifold datasets: sphere, gaussian, linear-gaussian, sigmoid.

Pure-function re-designs of reference/datasets.py:55-279. Sampling
semantics (distributions, padding layout, scoring formulas) are preserved
exactly; the stateful key-splitting is replaced by caller-owned keys so the
samplers compile into the fused train step.

Construction randomness (the mixing matrices ``A``) consumes splits of
``PRNGKey(seed)`` in the same order as the reference so the *manifold* is
seed-reproducible in spirit (exact bit-parity of A is NOT a goal — the
reference's full-rank resampling loop is reproduced behaviorally).
"""

from __future__ import annotations

from typing import ClassVar, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..evals.plots import pyplot
from ..utils.pytree import static_field

from .base import DistributionDataset, pad_with_zeros, padding_energy


def _dot_precision(fp32_dots: bool):
    """--precision fp32 → Precision.HIGHEST on the manifold dots, so data
    generation rounds like the model's dots. None = the backend's default
    for f32 dots (TF32 on the H100)."""
    return jax.lax.Precision.HIGHEST if fp32_dots else None


def _normal_mat(key, rows: int, cols: int) -> jax.Array:
    """Construction-time N(0,1) matrix draw, run eagerly inside
    ``_on_construction_device()`` (host CPU backend)."""
    return jax.random.normal(key, (rows, cols))


def _on_construction_device():
    """Construction randomness (the mixing matrices ``A``) runs on the
    host CPU backend: the full-rank check needs the matrix on the host
    anyway, so construction costs no device programs and no device syncs.
    A is not bit-pinned across backends by design (module docstring);
    every consumer (solo, grid) shares this construction path."""
    import contextlib

    try:
        # local_devices, not devices: under multi-process (--multihost)
        # global device 0 belongs to process 0 — eager construction on a
        # non-addressable device would make the host rank-check fetch
        # impossible on every other process
        return jax.default_device(jax.local_devices(backend="cpu")[0])
    except RuntimeError:
        return contextlib.nullcontext()  # no CPU backend: default device


class SphereDataset(DistributionDataset):
    """Uniform samples on S^{dim-1}, zero-padded to ambient dimension.

    Reference: reference/datasets.py:55-98.
    """

    dim: int = static_field(default=3)
    padding_dim: int = static_field(default=0)

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        g = jax.random.normal(key, (n, self.dim))
        on_sphere = g / jnp.linalg.norm(g, axis=1, keepdims=True)
        return pad_with_zeros(on_sphere, self.padding_dim)

    def score(self, batch: jax.Array) -> Dict[str, jax.Array]:
        real = batch[:, : self.dim]
        padding = batch[:, self.dim :]
        # (||x|| - R)^2 with R = 1; padding squared-norm.
        # Reference: reference/datasets.py:67-73.
        sphere_err = jnp.mean(jnp.square(jnp.linalg.norm(real, axis=1) - 1.0))
        pad_err = jnp.mean(jnp.square(jnp.linalg.norm(padding, axis=1)))
        return {"Sphere Error": sphere_err, "Padding Error": pad_err}

    def plot_batch(self, batch, fn=None):
        plt = pyplot()
        if plt is None:
            return
        norms = np.asarray(jnp.linalg.norm(batch, axis=1))
        bins = [0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2]
        plt.hist(norms, bins=bins)
        if fn is not None:
            plt.savefig(fn)
        plt.close()


class GaussianDataset(DistributionDataset):
    """Isotropic gaussian with optional noisy padding dimensions.

    Reference: reference/datasets.py:101-160 (defined but unwired in
    the reference CLI — wired here as an explicit ``--dataset gaussian``).
    """

    dim: int = static_field(default=3)
    padding_dim: int = static_field(default=0)
    noise_level: float = static_field(default=0.01)

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        k1, k2 = jax.random.split(key)
        core = jax.random.normal(k1, (n, self.dim))
        if self.noise_level > 0 and self.padding_dim > 0:
            # Isotropic cov = noise_level * I — equivalent to the reference's
            # multivariate_normal with diagonal cov (datasets.py:130-133).
            padding = jax.random.normal(k2, (n, self.padding_dim)) * jnp.sqrt(
                self.noise_level
            )
            return jnp.concatenate([core, padding], axis=1)
        return pad_with_zeros(core, self.padding_dim)

    # eigh of a small covariance is one-off host math; the engine honors
    # score_on_host by scoring generated batches with numpy.
    score_on_host: ClassVar[bool] = True

    def score(self, batch: jax.Array) -> Dict[str, jax.Array]:
        # Reference: reference/datasets.py:113-125.
        return self.score_host(np.asarray(batch))

    def score_host(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        padding = batch[:, self.dim:]
        mse = float(np.mean(np.sum(np.square(padding), axis=1)))
        cov_hat = np.atleast_2d(np.cov(batch.T))
        w_ht = np.linalg.eigh(cov_hat)[0]
        w_gt = np.ones_like(w_ht)
        return {
            "Squared Norm of padding dimensions": mse,
            "ground truth eigenvalue": w_gt,
            "learnt eigenvalue": w_ht,
        }

    def plot_batch(self, batch, fn=None):
        _plot_scatter_or_norms(self, batch, fn)


class LinearGaussianDataset(DistributionDataset):
    """Y = A X with X ~ N(0, I_k), A full-rank (dim × k), zero padding.

    Optional isotropic observation noise of variance ``var_added``.
    Reference: reference/datasets.py:163-228. ``A`` and
    ``transformed_cov = A Aᵀ`` are exposed for the warm-start initializer
    (reference/vae.py:87,93).
    """

    A: jax.Array  # (dim, intrinsic_dim)
    dim: int = static_field(default=3)
    intrinsic_dim: int = static_field(default=3)
    padding_dim: int = static_field(default=0)
    var_added: float = static_field(default=0.0)
    # --precision fp32: true-fp32 manifold dots, matching the model's dots
    fp32_dots: bool = static_field(default=False)

    @classmethod
    def create(
        cls,
        seed: int,
        dimension: int = 3,
        intrinsic_dimension: int = 3,
        padding_dimension: int = 0,
        var_added: float = 0.0,
        fp32_dots: bool = False,
    ) -> "LinearGaussianDataset":
        # Resample until full rank — behavioral port of the reference's
        # construction loop (reference/datasets.py:171-180). The rank
        # check runs on the HOST (numpy SVD): this is one-time setup math.
        target_rank = min(dimension, intrinsic_dimension)
        with _on_construction_device():
            key = jax.random.PRNGKey(seed)
            while True:
                key, mat_key = jax.random.split(key)
                mat = _normal_mat(mat_key, dimension, intrinsic_dimension)
                if int(np.linalg.matrix_rank(np.asarray(mat))) == target_rank:
                    break
        return cls(
            A=mat,
            dim=dimension,
            intrinsic_dim=intrinsic_dimension,
            padding_dim=padding_dimension,
            var_added=var_added,
            fp32_dots=fp32_dots,
        )

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim

    @property
    def transformed_cov(self) -> jax.Array:
        return self.A @ self.A.T

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        kx, kn = jax.random.split(key)
        x = jax.random.normal(kx, (n, self.intrinsic_dim))
        y = jnp.dot(x, self.A.T, precision=_dot_precision(self.fp32_dots))
        y = pad_with_zeros(y, self.padding_dim)
        if self.var_added > 0:
            y = y + jax.random.normal(kn, (n, self.ndim)) * jnp.sqrt(self.var_added)
        return y

    def score(self, batch: jax.Array) -> Dict[str, jax.Array]:
        padding = batch[:, self.dim :]
        # Reference: reference/datasets.py:201-206.
        return {"Squared Norm of padding dimensions": padding_energy(padding)}

    def plot_batch(self, batch, fn=None):
        _plot_scatter_or_norms(self, batch, fn)


class SigmoidDataset(DistributionDataset):
    """Y = [z, σ(z·A), 0-padding] with z ~ N(0, I_dim), A ~ N(0,1)^{dim×1}.

    Ambient dimension is dim + 1 + padding_dim. Reference:
    reference/datasets.py:230-279.
    """

    A: jax.Array  # (dim, 1)
    dim: int = static_field(default=3)
    padding_dim: int = static_field(default=0)
    fp32_dots: bool = static_field(default=False)

    @classmethod
    def create(
        cls, seed: int, dimension: int = 3, padding_dimension: int = 0,
        fp32_dots: bool = False,
    ) -> "SigmoidDataset":
        with _on_construction_device():
            key = jax.random.PRNGKey(seed)
            _, mat_key = jax.random.split(key)
            mat = _normal_mat(mat_key, dimension, 1)
        return cls(A=mat, dim=dimension, padding_dim=padding_dimension,
                   fp32_dots=fp32_dots)

    @property
    def ndim(self) -> int:
        return self.dim + self.padding_dim + 1

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        z = jax.random.normal(key, (n, self.dim))
        sig = jax.nn.sigmoid(
            jnp.dot(z, self.A, precision=_dot_precision(self.fp32_dots)))
        out = jnp.concatenate([z, sig], axis=1)
        return pad_with_zeros(out, self.padding_dim)

    def score(self, batch: jax.Array) -> Dict[str, jax.Array]:
        # NOTE (published-metric quirks, reproduced as-is from
        # reference/datasets.py:255-261):
        #   1. the σ-coordinate is compared against the *pre-sigmoid* logit
        #      z·A, not σ(z·A);
        #   2. ``codomain_hat`` is (n,) and ``codomain`` is (n,1), so the
        #      subtraction BROADCASTS to an (n,n) matrix of all cross pairs —
        #      the mean is ≈ Var(ĉ)+Var(c)+(E[ĉ]−E[c])², nonzero even for a
        #      perfect model. Computed here in the algebraically identical
        #      closed form (no n×n intermediate):
        #      mean(ĉ²) − 2·mean(ĉ)·mean(c) + mean(c²).
        codomain_hat = batch[:, self.dim]
        codomain = jnp.dot(batch[:, : self.dim], self.A,
                           precision=_dot_precision(self.fp32_dots))[:, 0]
        manifold_error = (
            jnp.mean(jnp.square(codomain_hat))
            - 2.0 * jnp.mean(codomain_hat) * jnp.mean(codomain)
            + jnp.mean(jnp.square(codomain))
        )
        padding = batch[:, self.dim + 1 :]
        return {
            "Squared Norm of Padding Dimensions": padding_energy(padding),
            "Squared Norm of Manifold Dimension": manifold_error,
        }

    def plot_batch(self, batch, fn=None, key: jax.Array | None = None):
        plt = pyplot()
        if plt is None:
            return
        n = batch.shape[0]
        if key is None:
            key = jax.random.PRNGKey(0)
        true_batch = self.sample(key, n)
        x = np.asarray(batch[:, : self.dim] @ self.A)
        y = np.asarray(batch[:, self.dim])
        plt.scatter(x, y)
        x_org = np.asarray(true_batch[:, : self.dim] @ self.A)
        y_org = np.asarray(true_batch[:, self.dim])
        plt.scatter(x_org, y_org)
        if fn is not None:
            plt.savefig(fn)
        plt.close()


def _plot_scatter_or_norms(ds, batch, fn=None):
    """2-D scatter for dim==2, otherwise sorted-norm curve.

    Reference plot semantics: reference/datasets.py:141-154,208-222.
    """
    plt = pyplot()
    if plt is None:
        return
    b = np.asarray(batch)
    if ds.dim == 2:
        plt.scatter(b[:, 0], b[:, 1])
    else:
        plt.plot(np.sort(np.linalg.norm(b, axis=1)))
        plt.ylabel("Norm of points")
    plt.title(f"Gaussian with dimension {ds.dim} and padding {ds.padding_dim}")
    if fn is not None:
        plt.savefig(fn)
    plt.close()
