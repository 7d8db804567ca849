"""Pure-JAX image tiling + resize — replaces the reference's OpenCV path.

The reference tiles generated images into a grid and resizes with cv2
(reference/utils.py:79-133, its only OpenCV use). This version is pure
JAX (jit-able) and writes PNGs via matplotlib when it is installed,
removing the cv2 dependency entirely.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def tile_images(
    imgs: jnp.ndarray,
    aspect_ratio: float = 1.0,
    border: int = 1,
    border_color: float = 0.0,
) -> jnp.ndarray:
    """Arrange (n, h, w[, c]) images into one grid image.

    Matches the reference's layout math (reference/utils.py:92-124):
    grid shape from sqrt(n·aspect), images mapped from [-1, 1] to [0, 1],
    `border` pixels between tiles.
    """
    if imgs.ndim not in (3, 4):
        raise ValueError("imgs has wrong number of dimensions.")
    squeeze_channel = imgs.ndim == 3
    if squeeze_channel:
        imgs = imgs[..., None]
    n, h, w, c = imgs.shape
    img_aspect = w / float(h)
    aspect = aspect_ratio * img_aspect
    th = int(math.ceil(math.sqrt(n * aspect)))
    tw = int(math.ceil(math.sqrt(n / aspect)))

    total = th * tw
    imgs01 = (imgs + 1.0) / 2.0
    pad_n = jnp.full((total - n, h, w, c), border_color, imgs.dtype)
    cells = jnp.concatenate([imgs01, pad_n], axis=0)
    cells = jnp.pad(
        cells,
        ((0, 0), (0, border), (0, border), (0, 0)),
        constant_values=border_color,
    )
    grid = cells.reshape(th, tw, h + border, w + border, c)
    grid = jnp.transpose(grid, (0, 2, 1, 3, 4))
    grid = grid.reshape(th * (h + border), tw * (w + border), c)
    grid = grid[: th * (h + border) - border, : tw * (w + border) - border]
    return grid[..., 0] if squeeze_channel else grid


def resize_image(img: jnp.ndarray, shape: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize (replaces cv2.resize at utils.py:129)."""
    out_shape = shape + img.shape[2:]
    return jax.image.resize(img, out_shape, method="bilinear")


def img_tile(
    imgs,
    fn: Optional[str],
    save: bool,
    aspect_ratio: float = 1.0,
    border: int = 1,
    border_color: float = 0.0,
    resize_to: Tuple[int, int] = (256, 256),
):
    """Reference-compatible entry point (reference/utils.py:79)."""
    tile = tile_images(jnp.asarray(imgs), aspect_ratio, border, border_color)
    tile = resize_image(tile, resize_to)
    tile = np.clip(np.asarray(tile), 0.0, 1.0)
    if save and fn is not None:
        from ..evals.plots import pyplot

        plt = pyplot()
        if plt is not None:
            plt.imsave(fn, tile, cmap="gray" if tile.ndim == 2 else None)
    return tile
