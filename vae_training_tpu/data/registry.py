"""Dataset registry / factory.

Replaces the reference's ``get_dataset`` if-chain (reference/run.py:46-54)
with an extensible registry. The reference silently returns ``None`` for its
own default ``--dataset 4gaussian`` (and then crashes downstream); here an
unknown name raises immediately with the available choices.
"""

from __future__ import annotations

from typing import Callable, Dict

from .base import DistributionDataset
from .synthetic import (
    GaussianDataset,
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
)

_REGISTRY: Dict[str, Callable[..., DistributionDataset]] = {}


def register_dataset(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def dataset_names():
    return sorted(_REGISTRY)


@register_dataset("sphere")
def _make_sphere(seed, args) -> SphereDataset:
    return SphereDataset(
        dim=args.dataset_dimension, padding_dim=args.padding_dim
    )


@register_dataset("linear_gaussian")
def _make_linear_gaussian(seed, args) -> LinearGaussianDataset:
    return LinearGaussianDataset.create(
        seed,
        dimension=args.dataset_dimension,
        intrinsic_dimension=args.dataset_intrinsic_dimension,
        padding_dimension=args.padding_dim,
        var_added=args.dataset_noise,
        fp32_dots=getattr(args, "precision", "bf16") == "fp32",
    )


@register_dataset("sigmoid")
def _make_sigmoid(seed, args) -> SigmoidDataset:
    return SigmoidDataset.create(
        seed,
        dimension=args.dataset_dimension,
        padding_dimension=args.padding_dim,
        fp32_dots=getattr(args, "precision", "bf16") == "fp32",
    )


@register_dataset("image")
def _make_image(seed, args):
    """Epoch-mode image corpus (conv VAE path, BASELINE.json config 5)."""
    from .images import ImageDataset

    source = getattr(args, "image_source", "synthetic")
    if source == "synthetic":
        return ImageDataset.synthetic_digits(
            seed,
            n=getattr(args, "num_images", 4096),
            size=getattr(args, "image_size", 28),
        )
    if source.endswith(".npz"):
        return ImageDataset.from_npz(
            source, pixel_range=getattr(args, "image_range", "auto"))
    return ImageDataset.from_folder(source, size=getattr(args, "image_size", None))


@register_dataset("gaussian")
def _make_gaussian(seed, args) -> GaussianDataset:
    # Wired explicitly (the reference defines GaussianDataset at
    # datasets.py:101-160 but never reaches it from the CLI).
    return GaussianDataset(
        dim=args.dataset_dimension,
        padding_dim=args.padding_dim,
        noise_level=args.dataset_noise,
    )


def get_dataset(name: str, seed: int, args) -> DistributionDataset:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset {name!r}. Available: {dataset_names()}"
        ) from None
    return factory(seed, args)
