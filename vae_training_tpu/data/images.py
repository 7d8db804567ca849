"""Epoch-mode image datasets for the conv-VAE configuration.

The reference's epoch path trains from torch/torchvision dataloaders
(reference/model.py:176-193) and tiles results with OpenCV
(reference/utils.py:79-133). On-device replacement: the ENTIRE
dataset lives as one device array; an epoch is a scanned pass over a
shuffled index permutation computed on device — no host dataloader, no per
-batch host↔device copies, no cv2.

Sources:
  - ``synthetic_digits``: procedural MNIST-scale images (hermetic — no
    network/downloads), parameterized by seed;
  - ``from_npz`` / ``from_folder``: load real image corpora from disk
    (matplotlib imread replaces the cv2 loader path).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import PyTreeNode, static_field


def _digit_image(rng: np.random.RandomState, size: int) -> np.ndarray:
    """One procedural 'digit-like' grayscale image in [-1, 1]: random strokes
    (lines/arcs) on an empty canvas, MNIST-ish statistics."""
    img = np.zeros((size, size), np.float32)
    n_strokes = rng.randint(2, 5)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n_strokes):
        kind = rng.randint(2)
        if kind == 0:  # line segment
            x0, y0, x1, y1 = rng.uniform(2, size - 2, 4)
            t = np.linspace(0, 1, 64)[:, None]
            px = x0 + (x1 - x0) * t
            py = y0 + (y1 - y0) * t
            d2 = (xx[None] - px[:, None]) ** 2 + (yy[None] - py[:, None]) ** 2
            img += np.exp(-d2.min(0) / 1.5)
        else:  # arc
            cx, cy = rng.uniform(4, size - 4, 2)
            r = rng.uniform(2, size / 3)
            a0 = rng.uniform(0, 2 * np.pi)
            a1 = a0 + rng.uniform(np.pi / 2, 2 * np.pi)
            t = np.linspace(a0, a1, 64)[:, None]
            px = cx + r * np.cos(t)
            py = cy + r * np.sin(t)
            d2 = (xx[None] - px[:, None]) ** 2 + (yy[None] - py[:, None]) ** 2
            img += np.exp(-d2.min(0) / 1.5)
    img = np.clip(img, 0, 1)
    return img * 2.0 - 1.0  # [-1, 1], the range img_tile expects


class ImageDataset(PyTreeNode):
    """Finite image corpus on device; epoch-mode training.

    ``images``: (n, h, w, c) float32 in [-1, 1]. The flattened pixel count
    is the model's data dimension (the VAE treats images as vectors for the
    ELBO, like the reference's ``batch.reshape(n, -1)`` at vae.py:124).
    """

    images: jax.Array
    h: int = static_field(default=28)
    w: int = static_field(default=28)
    c: int = static_field(default=1)

    # --- constructors -----------------------------------------------------
    @classmethod
    def synthetic_digits(cls, seed: int, n: int = 4096, size: int = 28
                         ) -> "ImageDataset":
        rng = np.random.RandomState(seed)
        imgs = np.stack([_digit_image(rng, size) for _ in range(n)])
        return cls(images=jnp.asarray(imgs[..., None]), h=size, w=size, c=1)

    @classmethod
    def from_npz(cls, path: str, key: str = "images",
                 pixel_range: str = "auto") -> "ImageDataset":
        """Load an (n,h,w[,c]) corpus from ``path``.

        ``pixel_range`` declares the source range explicitly:
          - ``"0_255"``: remap x/127.5 - 1
          - ``"0_1"``:   remap x*2 - 1
          - ``"pm1"``:   already [-1, 1], pass through unchanged
          - ``"auto"`` (default): honor a ``pixel_range`` metadata array in
            the npz if present, else fall back to the heuristic below.
        Heuristic (each auto decision is announced on stderr — the range
        can't be inferred with certainty): max > 1.5 ⇒ 0..255;
        all-nonnegative (incl. integer {0, 1} binarized corpora) ⇒ [0, 1]
        like from_folder; any negative value ⇒ already [-1, 1], pass
        through unchanged.
        """
        import sys

        data = np.load(path)
        raw = data[key]
        arr = raw.astype(np.float32)
        if arr.ndim == 3:
            arr = arr[..., None]
        if pixel_range == "auto" and "pixel_range" in getattr(
                data, "files", ()):
            pixel_range = str(np.asarray(data["pixel_range"]).item())
        if pixel_range == "auto":
            if arr.max() > 1.5:
                pixel_range = "0_255"
                print(f"[images] {path}: detected 0..255 range, remapping "
                      f"to [-1, 1] (x/127.5 - 1); pass pixel_range "
                      f"explicitly to override", file=sys.stderr, flush=True)
            elif arr.min() >= 0.0:
                # integer {0,1} = binarized corpus → {-1,+1}, same as
                # nonnegative floats; NOT 0..255 (that would flatten it
                # to a near-constant ~-1 corpus). Anything with negative
                # values (integer or float) already carries [-1,1]
                # semantics and must pass through untouched.
                pixel_range = "0_1"
                print(f"[images] {path}: all-nonnegative values — assuming "
                      f"[0, 1] and remapping to [-1, 1] (x*2 - 1); if the "
                      f"corpus is ALREADY [-1, 1], pass pixel_range='pm1' "
                      f"(or store a pixel_range='pm1' array in the npz)",
                      file=sys.stderr, flush=True)
            else:
                pixel_range = "pm1"
        if pixel_range in ("0_255", "255"):
            arr = arr / 127.5 - 1.0
        elif pixel_range in ("0_1", "01"):
            arr = arr * 2.0 - 1.0
        elif pixel_range not in ("pm1", "-1_1"):
            raise ValueError(
                f"unknown pixel_range {pixel_range!r}; expected "
                f"auto | 0_255 | 0_1 | pm1")
        n, h, w, c = arr.shape
        return cls(images=jnp.asarray(arr), h=h, w=w, c=c)

    @classmethod
    def from_folder(cls, path: str, size: Optional[int] = None
                    ) -> "ImageDataset":
        """Load every PNG/JPG in a directory (replaces the cv2 loader)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        files = sorted(
            f for f in os.listdir(path)
            if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        if not files:
            raise ValueError(f"no images found in {path}")
        imgs = []
        for f in files:
            a = plt.imread(os.path.join(path, f)).astype(np.float32)
            if a.max() > 1.5:
                a = a / 255.0
            if a.ndim == 3 and a.shape[-1] == 4:
                a = a[..., :3]
            if a.ndim == 2:
                a = a[..., None]
            imgs.append(a * 2.0 - 1.0)
        arr = np.stack(imgs)
        ds = cls(images=jnp.asarray(arr), h=arr.shape[1], w=arr.shape[2],
                 c=arr.shape[3])
        if size is not None and (size != ds.h or size != ds.w):
            resized = jax.image.resize(
                ds.images, (arr.shape[0], size, size, ds.c), "bilinear")
            ds = cls(images=resized, h=size, w=size, c=ds.c)
        return ds

    # --- Dataset interface -------------------------------------------------
    @property
    def is_epochs(self) -> bool:
        return True

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.h, self.w, self.c)

    @property
    def dimension(self) -> int:
        return self.h * self.w * self.c

    @property
    def ndim(self) -> int:
        return self.dimension

    def sample(self, key: jax.Array, n: int) -> jax.Array:
        """Random subset, flattened to (n, h*w*c) — used by eval."""
        idx = jax.random.randint(key, (n,), 0, self.images.shape[0])
        return self.images[idx].reshape(n, -1)

    def get_batch(self, key, size, return_latents=False):
        batch = self.sample(key, size)
        if return_latents:
            return batch, None
        return batch

    def epoch_permutation(self, key: jax.Array) -> jax.Array:
        return jax.random.permutation(key, self.images.shape[0])

    def score(self, batch):
        # Epoch datasets have no analytic oracle; the engine skips scoring
        # (mirrors reference/model.py:161's is_epochs guard).
        return {}

    def score_batch(self, batch):
        return {}

    def plot_batch(self, batch, fn=None):
        from ..ops.images import img_tile

        b = np.asarray(batch)
        if b.ndim == 2:  # flattened → images
            b = b.reshape(-1, self.h, self.w, self.c)
        if b.shape[-1] == 1:
            b = b[..., 0]
        img_tile(b[:64], fn, save=fn is not None)

    def save(self, fn: str) -> None:
        # In-memory images are always [-1, 1]; the pixel_range marker makes
        # a save→load round trip exact (from_npz's "auto" would otherwise
        # remap an all-nonnegative corpus a second time).
        np.savez(fn, images=np.asarray(self.images), pixel_range="pm1")

    def load(self, fn: str) -> "ImageDataset":
        return ImageDataset.from_npz(fn if fn.endswith(".npz") else fn + ".npz")
