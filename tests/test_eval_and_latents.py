"""Fused eval_step parity with the unfused path + latent distribution
options."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import LinearGaussianDataset, get_dataset
from vae_training_tpu.models import build_vae
from vae_training_tpu.runio import make_output_dir
from vae_training_tpu.train import Trainer, TrainState, make_step_fns, split_z


def test_eval_step_matches_unfused():
    dataset = LinearGaussianDataset.create(2, 3, 3, 4)
    model = build_vae(data_dim=dataset.dimension, latent_dim=5,
                      epsilon=-1.0, tunable_decoder_var=True)
    tx = optax.adam(1e-3)
    params = model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 7)), jnp.zeros((1, 5)),
        jnp.zeros((1, 7)))["params"]
    fns = make_step_fns(model, dataset, tx, batch_size=16)

    dk, zk = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    eps = jnp.float32(-1.0)
    out = jax.device_get(fns.eval_step(params, dk, zk, eps, n=64))

    # unfused: same keys, same math
    from vae_training_tpu.train.step import sample_z

    real = dataset.sample(dk, 64)
    z = sample_z(zk, 64, 5, 7)
    z1, z2 = split_z(z, 5)
    loss, dkl, mse, logvar_e, epsilon = fns.eval_loss(params, real, z1, z2)
    fake = fns.generate(params, z1, z2, eps)
    score = jax.device_get(fns.score(fake))

    np.testing.assert_allclose(out["VAE Loss"], float(loss), rtol=1e-6)
    np.testing.assert_allclose(out["KL divergence"], float(dkl), rtol=1e-6)
    np.testing.assert_allclose(out["mse"], float(mse), rtol=1e-6)
    np.testing.assert_allclose(out["_logvar_e"], np.asarray(logvar_e),
                               rtol=1e-6)
    for k, v in score.items():
        np.testing.assert_allclose(out[k], np.asarray(v), rtol=1e-5,
                                   err_msg=k)


def _trainer(tmpdir, **kw):
    cfg = RunConfig(
        name="lat", dataset="linear_gaussian", encoder_layer_sizes="",
        layer_sizes="", latent_dimension=5, padding_dim=2,
        dataset_dimension=3, num_batches=10, batch_size=8,
        overwrite=True, tqdm=False, data_dir=tmpdir, **kw,
    ).validate()
    out = make_output_dir(cfg.name, True, cfg, data_dir=tmpdir)
    ds = get_dataset(cfg.dataset, 2, cfg)
    return Trainer(cfg, ds, out)


def test_gaussian_latent_shape(tmp_outdir):
    tr = _trainer(tmp_outdir)
    z = tr.sample_latent(jax.random.PRNGKey(0), 12)
    # z1 (latent) ⊕ z2 (data) — reference/model.py:225-228
    assert z.shape == (12, 5 + 5)


def test_logistic_latent_branch(tmp_outdir):
    tr = _trainer(tmp_outdir)
    tr.cfg.latent_distribution = "logistic"
    z = tr.sample_latent(jax.random.PRNGKey(0), 12)
    assert z.shape == (12, 5)
    assert bool(jnp.isfinite(z).all())
    ll = tr.latent_likelihood(z)
    assert np.isfinite(float(ll))
    # gaussian likelihood of the standard prior
    tr.cfg.latent_distribution = "gaussian"
    zg = jnp.zeros((4, 5))
    expected = 5 * -0.5 * np.log(2 * np.pi)
    np.testing.assert_allclose(float(tr.latent_likelihood(zg)), expected,
                               rtol=1e-6)


def test_unknown_latent_distribution_raises(tmp_outdir):
    tr = _trainer(tmp_outdir)
    tr.cfg.latent_distribution = "cauchy"
    with pytest.raises(NotImplementedError):
        tr.sample_latent(jax.random.PRNGKey(0), 4)
