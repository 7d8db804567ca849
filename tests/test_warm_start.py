"""Warm-start analytic initializers against the reference's formulas
(reference/vae.py:62-107). The deterministic part of each kernel is
checked exactly by subtracting the known perturbation scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import LinearGaussianDataset, SigmoidDataset, get_dataset
from vae_training_tpu.models import build_vae
from vae_training_tpu.models.warm_start import (
    warm_start_linear_gaussian,
    warm_start_sigmoid,
)
from vae_training_tpu.runio import make_output_dir
from vae_training_tpu.train import Trainer

KEY = jax.random.PRNGKey(7)


def init_params(model, data_dim, latent_dim):
    return dict(
        model.init(
            KEY, jnp.zeros((1, data_dim)), jnp.zeros((1, latent_dim)),
            jnp.zeros((1, data_dim)),
        )["params"]
    )


def test_sigmoid_warm_start_structure():
    ds = SigmoidDataset.create(2, dimension=3, padding_dimension=2)
    latent = ds.dimension  # must equal ambient dim (= 6)
    model = build_vae(data_dim=ds.dimension, latent_dim=latent,
                      dataset_name="sigmoid")
    params = init_params(model, ds.dimension, latent)
    new = warm_start_sigmoid(params, ds, latent, KEY)

    cut = ds.dim + 1
    eye = np.eye(latent)
    expected_dec = eye.copy()
    expected_dec[cut:, cut:] = 0.0
    # perturbation scale 0.1 ⇒ means within ~6 sigma of a 0.1-std draw
    assert np.abs(np.asarray(new["Decoder"]["FC0"]["kernel"]) - expected_dec).max() < 0.6
    assert np.abs(np.asarray(new["SigDecoder"]["FC0"]["kernel"])).max() < 0.6
    assert np.abs(np.asarray(new["Encoder"]["FC0"]["kernel"]) - expected_dec).max() < 0.6
    eps_p = np.asarray(new["epsilon_p"])
    expected_eps = np.zeros(latent)
    expected_eps[cut:] = -3.0
    assert np.abs(eps_p - expected_eps).max() < 0.6
    # biases untouched
    np.testing.assert_array_equal(
        np.asarray(new["Decoder"]["FC0"]["bias"]),
        np.asarray(params["Decoder"]["FC0"]["bias"]),
    )


def test_sigmoid_warm_start_requires_matching_latent():
    ds = SigmoidDataset.create(2, dimension=3, padding_dimension=2)
    model = build_vae(data_dim=ds.dimension, latent_dim=4, dataset_name="sigmoid")
    params = init_params(model, ds.dimension, 4)
    with pytest.raises(ValueError, match="latent_dim == dataset dimension"):
        warm_start_sigmoid(params, ds, 4, KEY)


def test_linear_warm_start_structure():
    ds = LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                      padding_dimension=4)
    latent, off = 8, 1
    model = build_vae(data_dim=ds.dimension, latent_dim=latent)
    params = init_params(model, ds.dimension, latent)
    new = warm_start_linear_gaussian(params, ds, latent, off, KEY)

    dec = np.asarray(new["Decoder"]["FC0"]["kernel"])  # (latent, data)
    A = np.asarray(ds.A)
    # First 3 latent rows reconstruct via A (cols 0..2), padding rows ~0.
    assert np.abs(dec[:3, :3] - A.T).max() < 0.06  # 0.01-scale perturbation
    assert np.abs(dec[ds.dim + off:, :]).max() < 0.06
    assert np.abs(dec[:, ds.dim:]).max() < 0.06  # padding outputs ~0

    enc = np.asarray(new["Encoder"]["FC0"]["kernel"])  # (data, latent)
    pinv = np.linalg.pinv(A)  # (3, 3)
    assert np.abs(enc[:3, :3] - pinv.T).max() < 0.06
    assert np.abs(enc[:, 3:]).max() < 0.06

    eps_p = np.asarray(new["epsilon_p"])
    expected = np.zeros(latent)
    expected[: ds.intrinsic_dim + off] = -3.0
    assert np.abs(eps_p - expected).max() < 0.6


def test_linear_warm_start_preconditions():
    ds = LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                      padding_dimension=0)
    model = build_vae(data_dim=3, latent_dim=4)
    params = init_params(model, 3, 4)
    with pytest.raises(ValueError, match="latent_off_dimension"):
        warm_start_linear_gaussian(params, ds, 4, 1, KEY)


def test_warm_start_accelerates_training(tmp_outdir):
    """Warm-started linear VAE should start with a far lower loss."""
    results = {}
    for ws in (False, True):
        cfg = RunConfig(
            name=f"ws{ws}", dataset="linear_gaussian",
            encoder_layer_sizes="", layer_sizes="",
            latent_dimension=8, padding_dim=3, dataset_dimension=3,
            num_batches=10, batch_size=50, epsilon=-1.0,
            tunable_decoder_var=True, warm_start=ws, latent_off_dimension=1,
            dataset_seed=2, overwrite=True, tqdm=False, data_dir=tmp_outdir,
        ).validate()
        out = make_output_dir(cfg.name, True, cfg, data_dir=tmp_outdir)
        ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
        trainer = Trainer(cfg, ds, out)
        results[ws] = float(trainer.compute_stats()["VAE Loss"])
    assert results[True] < results[False]
