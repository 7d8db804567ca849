"""One training step of the package against the plain float32 reference.

For every row of the three reference sweeps (21 linear, 18 sigmoid, 15
sphere) and the bench's conv config, at --precision fp32: the loss, the
gradients and the first Adam update of the package's step functions match
``vae_training_tpu.reference`` on the same params, batch and noise. On the
CPU both sides run true-fp32 arithmetic, so the bounds only absorb
summation order.
"""

import jax
import numpy as np
import optax
import pytest

import bench
import sweep as sweep_mod
from vae_training_tpu import reference
from vae_training_tpu.data import get_dataset
from vae_training_tpu.models import build_vae
from vae_training_tpu.models.conv import build_conv_vae
from vae_training_tpu.train.state import make_adam
from vae_training_tpu.train.step import make_elbo_grad_fn

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4

ROWS = [cfg for family in ("linear", "sigmoid", "sphere")
        for cfg in sweep_mod.sweep_configs(family, "data", None)]


def _package_and_reference(cfg, model, x, spec):
    params = jax.jit(model.init)(jax.random.PRNGKey(cfg.model_seed), x[:1])[
        "params"]
    rng = np.random.RandomState(cfg.dataset_seed)
    z1 = rng.randn(x.shape[0], model.latent_dim).astype(np.float32)
    z2 = rng.randn(*x.shape).astype(np.float32)

    tx = make_adam(cfg.learning_rate)
    loss, grads = jax.jit(make_elbo_grad_fn(model))(params, x, z1, z2)
    updates, _ = tx.update(grads, tx.init(params), params)
    new_params = optax.apply_updates(params, updates)

    ref_loss, ref_grads, ref_new = jax.jit(
        lambda p: reference.step(spec, p, x, z1, z2, cfg.learning_rate))(params)
    assert abs(float(loss) - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    assert reference.rel_err(grads, ref_grads) <= GRAD_RTOL
    delta = jax.tree_util.tree_map(lambda a, b: a - b, new_params, params)
    ref_delta = jax.tree_util.tree_map(lambda a, b: a - b, ref_new, params)
    assert reference.rel_err(delta, ref_delta) <= GRAD_RTOL


@pytest.mark.parametrize("cfg", ROWS, ids=[c.name for c in ROWS])
def test_sweep_row_step_matches_reference(cfg):
    cfg.precision = "fp32"
    dataset = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    model = build_vae(
        data_dim=dataset.dimension, latent_dim=cfg.latent_dimension,
        encoder_layer_sizes=cfg.encoder_layer_sizes,
        decoder_layer_sizes=cfg.layer_sizes, epsilon=cfg.epsilon,
        tunable_decoder_var=cfg.tunable_decoder_var,
        dataset_name=cfg.dataset, precision="fp32")
    x = np.asarray(dataset.sample(jax.random.PRNGKey(1), cfg.batch_size))
    spec = reference.Spec(cfg.epsilon, cfg.tunable_decoder_var,
                          dual=cfg.dataset == "sigmoid")
    _package_and_reference(cfg, model, x, spec)


def test_conv_step_matches_reference():
    cfg = bench.make_conv_cfg("fp32")
    cfg.num_images = 256  # the step sees one batch; the corpus size is moot
    dataset = get_dataset(cfg.dataset, 0, cfg)
    model = build_conv_vae(
        image_hwc=tuple(dataset.shape), latent_dim=cfg.latent_dimension,
        channels_spec=cfg.conv_channels, epsilon=cfg.epsilon,
        tunable_decoder_var=cfg.tunable_decoder_var, precision="fp32")
    x = np.asarray(dataset.sample(jax.random.PRNGKey(1), cfg.batch_size))
    spec = reference.Spec(cfg.epsilon, cfg.tunable_decoder_var,
                          image_hwc=tuple(dataset.shape))
    _package_and_reference(cfg, model, x, spec)


def test_rel_err_is_per_leaf():
    """A wrong small leaf is not hidden by a large correct one."""
    want = {"big": np.full(100, 1e3), "small": np.array([1.0])}
    got = {"big": want["big"], "small": np.array([1.1])}
    assert reference.rel_err(got, want) == pytest.approx(0.1)
    assert reference.rel_err({"z": np.array([1e-3])},
                             {"z": np.array([0.0])}) == pytest.approx(1e-3)
