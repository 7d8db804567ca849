"""Dataset abstractions: pure-function samplers with analytic scoring oracles.

Accelerator-first redesign of the reference's stateful ``Dataset`` /
``DistributionDataset`` classes (reference/datasets.py:12-52). The
reference mutates a per-dataset PRNG key on every ``get_batch`` call from
Python, which forces a host round-trip per training step. Here a dataset is
an immutable pytree (``utils.pytree.PyTreeNode``): static geometry as pytree
metadata, learned-manifold arrays (e.g. the mixing matrix ``A``) as leaves.
``sample(key, n)`` is a pure jit-able function, so the sampler compiles
*inside* the fused train step and batches never leave the device.

Key discipline: callers own keys. The training engine folds a base data key
with the step index (``fold_in``) so every step of a ``lax.scan`` chunk gets
an independent stream without any host-side state.
"""

from __future__ import annotations

from typing import ClassVar, Dict

import jax
import jax.numpy as jnp

from ..utils.pytree import PyTreeNode


class DistributionDataset(PyTreeNode):
    """An infinite sampler over a known manifold, with analytic scoring.

    Subclasses implement:
      - ``sample(key, n) -> (n, ndim) array`` — pure, jit-able
      - ``score(batch) -> dict[str, scalar]`` — analytic ground-truth
        metrics against the known manifold, jit-able
      - ``plot_batch(batch, fn)`` — host-side matplotlib diagnostic
      - ``ndim`` property — ambient dimensionality

    Mirrors the capability surface of the reference ABCs
    (reference/datasets.py:12-52): ``is_epochs`` False ⇒ the engine
    uses the infinite-sampler training loop; ``shape``/``dimension`` feed
    model construction; ``save``/``load`` are manifold persistence hooks.
    """

    # --- interface -------------------------------------------------------
    @property
    def is_epochs(self) -> bool:
        return False

    @property
    def ndim(self) -> int:
        raise NotImplementedError

    @property
    def shape(self) -> tuple:
        return (self.ndim,)

    @property
    def dimension(self) -> int:
        d = 1
        for s in self.shape:
            d *= int(s)
        return d

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        raise NotImplementedError

    def score(self, batch: jax.Array) -> Dict[str, jax.Array]:
        raise NotImplementedError

    # Datasets whose scoring needs decompositions that are unreliable on
    # accelerator runtimes (SVD/eig family) set this True and implement
    # score_host; the engine then scores generated batches on the host
    # instead of fusing score() into the compiled eval program.
    # (ClassVar: not a pytree/dataclass field.)
    score_on_host: ClassVar[bool] = False

    def score_host(self, batch) -> Dict[str, float]:
        raise NotImplementedError

    def plot_batch(self, batch, fn=None):  # host-side, matplotlib
        raise NotImplementedError

    # Reference parity: get_batch(size, return_latents) returns latents=None
    # for all live datasets (reference/datasets.py:82-84,193-195,247-249).
    def get_batch(self, key: jax.Array, size: int, return_latents: bool = False):
        batch = self.sample(key, size)
        if return_latents:
            return batch, None
        return batch

    # score_batch is the reference's name (reference/datasets.py:67).
    def score_batch(self, batch: jax.Array) -> Dict[str, jax.Array]:
        return self.score(batch)

    # Manifold persistence. The reference's save/load are no-ops for all
    # live datasets (reference/datasets.py:94-98,224-228,275-279); here
    # the manifold arrays are pytree leaves so checkpointing is handled by
    # runio.checkpoint — these remain hooks for exotic datasets.
    def save(self, fn: str) -> None:
        pass

    def load(self, fn: str):
        return self


def pad_with_zeros(x: jax.Array, padding_dim: int) -> jax.Array:
    """Append `padding_dim` zero ambient dimensions to (n, d) samples."""
    if padding_dim == 0:
        return x
    return jnp.pad(x, ((0, 0), (0, padding_dim)))


def padding_energy(padding: jax.Array) -> jax.Array:
    """Mean squared norm of the padding coordinates — the shared oracle.

    Matches the reference metric `mean(sum(padding**2, axis=1))`
    (reference/datasets.py:205, :260) and `norm(padding)**2`
    (reference/datasets.py:71).
    """
    return jnp.mean(jnp.sum(jnp.square(padding), axis=1))
