"""Dataset samplers: shapes, manifold structure, scoring oracles, jit-ability.

The analytic score oracles double as integration oracles for training tests
(SURVEY.md §4): real data must score ≈ 0 on every manifold metric.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vae_training_tpu.data import (
    GaussianDataset,
    LinearGaussianDataset,
    SigmoidDataset,
    SphereDataset,
    get_dataset,
)


class Args:
    dataset_dimension = 3
    dataset_intrinsic_dimension = 3
    padding_dim = 4
    dataset_noise = 0.0


KEY = jax.random.PRNGKey(0)


def test_sphere_shapes_and_manifold():
    ds = SphereDataset(dim=3, padding_dim=4)
    assert ds.ndim == 7 and ds.shape == (7,) and ds.dimension == 7
    batch = ds.sample(KEY, 256)
    assert batch.shape == (256, 7)
    np.testing.assert_allclose(
        np.linalg.norm(batch[:, :3], axis=1), np.ones(256), rtol=1e-5
    )
    assert np.all(batch[:, 3:] == 0)


def test_sphere_score_real_data_is_zero():
    ds = SphereDataset(dim=5, padding_dim=2)
    score = ds.score(ds.sample(KEY, 512))
    assert float(score["Sphere Error"]) < 1e-9
    assert float(score["Padding Error"]) == 0.0


def test_linear_gaussian_manifold_and_score():
    ds = LinearGaussianDataset.create(2, dimension=6, intrinsic_dimension=3,
                                      padding_dimension=5)
    assert ds.A.shape == (6, 3)
    # host numpy: the rank check the constructor itself runs
    assert int(np.linalg.matrix_rank(np.asarray(ds.A))) == 3
    assert ds.ndim == 11
    batch = ds.sample(KEY, 2048)
    assert batch.shape == (2048, 11)
    assert np.all(batch[:, 6:] == 0)
    # Samples lie in the column space of A: projecting off it leaves ~0.
    A64 = np.asarray(ds.A, np.float64)
    proj = A64 @ np.linalg.pinv(A64)
    b64 = np.asarray(batch[:, :6], np.float64)
    residual = b64 - b64 @ proj.T
    # batch is float32; residual bounded by f32 matmul roundoff
    assert float(np.abs(residual).max()) < 5e-3
    score = ds.score(batch)
    assert float(score["Squared Norm of padding dimensions"]) == 0.0
    # Empirical covariance approaches A Aᵀ.
    emp = np.cov(np.asarray(batch[:, :6]).T)
    np.testing.assert_allclose(emp, np.asarray(ds.transformed_cov), atol=0.5)


def test_linear_gaussian_noise_added():
    ds = LinearGaussianDataset.create(2, dimension=3, intrinsic_dimension=3,
                                      padding_dimension=2, var_added=0.5)
    batch = ds.sample(KEY, 4096)
    pad_var = float(np.var(np.asarray(batch[:, 3:])))
    assert abs(pad_var - 0.5) < 0.1


def test_sigmoid_structure_and_score():
    ds = SigmoidDataset.create(7, dimension=3, padding_dimension=2)
    assert ds.ndim == 6  # dim + 1 sigma coordinate + padding
    batch = ds.sample(KEY, 512)
    assert batch.shape == (512, 6)
    sig = jax.nn.sigmoid(batch[:, :3] @ ds.A)[:, 0]
    np.testing.assert_allclose(np.asarray(batch[:, 3]), np.asarray(sig), rtol=1e-6)
    assert np.all(batch[:, 4:] == 0)
    score = ds.score(batch)
    # Published quirk preserved: the manifold metric compares σ(z·A)
    # against the *logit* z·A, so it is NOT zero on real data
    # (reference/datasets.py:255-261).
    assert float(score["Squared Norm of Padding Dimensions"]) == 0.0
    assert float(score["Squared Norm of Manifold Dimension"]) > 0.0
    # Second published quirk preserved: the reference subtracts an (n,1)
    # codomain from an (n,) codomain_hat, broadcasting to an (n,n) matrix
    # of all cross pairs before the mean (reference/datasets.py:256-258).
    # Our closed form must equal the literal broadcast.
    c_hat = np.asarray(batch[:, 3])
    c = np.asarray(batch[:, :3] @ ds.A)  # (n, 1)
    literal = float(np.mean(np.square(c_hat - c)))  # (n,) - (n,1) → (n,n)
    np.testing.assert_allclose(
        float(score["Squared Norm of Manifold Dimension"]), literal, rtol=1e-5
    )


def test_gaussian_dataset_score_keys():
    ds = GaussianDataset(dim=3, padding_dim=2, noise_level=0.01)
    batch = ds.sample(KEY, 512)
    assert batch.shape == (512, 5)
    pad_var = float(np.var(np.asarray(batch[:, 3:])))
    assert abs(pad_var - 0.01) < 0.01
    score = ds.score(batch)
    assert set(score) == {
        "Squared Norm of padding dimensions",
        "ground truth eigenvalue",
        "learnt eigenvalue",
    }


def test_samplers_are_deterministic_and_jittable():
    for ds in [
        SphereDataset(dim=3, padding_dim=2),
        LinearGaussianDataset.create(2, 3, 3, 2),
        SigmoidDataset.create(2, 3, 2),
        GaussianDataset(dim=3, padding_dim=2, noise_level=0.0),
    ]:
        a = ds.sample(KEY, 16)
        b = ds.sample(KEY, 16)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        jitted = jax.jit(lambda k, d=ds: d.sample(k, 16))
        np.testing.assert_allclose(
            np.asarray(jitted(KEY)), np.asarray(a), rtol=1e-6
        )
        # score is jit-able (it runs inside compiled eval) unless the
        # dataset opted into host-side scoring
        if not getattr(ds, "score_on_host", False):
            jax.jit(ds.score)(a)
        else:
            ds.score_host(np.asarray(a))


def test_dataset_is_a_pytree():
    ds = LinearGaussianDataset.create(2, 3, 3, 2)
    leaves = jax.tree_util.tree_leaves(ds)
    assert len(leaves) == 1  # only A; geometry is static metadata
    ds2 = jax.tree_util.tree_map(lambda x: x, ds)
    assert ds2.dim == ds.dim


def test_registry_factory_and_unknown_name():
    args = Args()
    ds = get_dataset("linear_gaussian", 2, args)
    assert isinstance(ds, LinearGaussianDataset)
    ds = get_dataset("gaussian", 2, args)
    assert isinstance(ds, GaussianDataset)
    with pytest.raises(ValueError, match="Unknown dataset"):
        get_dataset("4gaussian", 2, args)


def test_sampler_golden_values():
    """Pinned sampler outputs at fixed seeds (SURVEY §4: golden-value tests
    guard against accidental sampler-semantics changes across versions)."""
    key = jax.random.PRNGKey(7)
    goldens = {
        "sphere": (
            SphereDataset(dim=3, padding_dim=2),
            [[0.217958, 0.943565, -0.249357, 0.0, 0.0],
             [-0.197265, 0.861473, 0.467922, 0.0, 0.0]],
        ),
        "linear": (
            LinearGaussianDataset.create(2, 3, 3, 2),
            [[4.017021, 0.271658, -0.309552, 0.0, 0.0],
             [0.626419, -3.464566, -2.045262, 0.0, 0.0]],
        ),
        "sigmoid": (
            SigmoidDataset.create(2, 3, 2),
            [[0.451235, 1.953451, -0.516239, 0.909121, 0.0, 0.0],
             [-0.14094, 0.615497, 0.334316, 0.258642, 0.0, 0.0]],
        ),
        "gaussian": (
            GaussianDataset(dim=3, padding_dim=2, noise_level=0.01),
            [[1.114047, 0.141631, -0.522454, 0.045413, 0.093916],
             [-0.433046, 2.412499, -0.821474, -0.026894, -0.019085]],
        ),
    }
    for name, (ds, expected) in goldens.items():
        got = np.asarray(ds.sample(key, 2))
        np.testing.assert_allclose(got, np.asarray(expected), atol=2e-6,
                                   err_msg=name)

def test_precision_flag_reaches_dataset_sampling_dots():
    """--precision fp32 threads into the manifold dots of the samplers
    (matching the model's dots), and on CPU — where both modes are exact
    fp32 — changes nothing."""
    import jax

    from vae_training_tpu.config import RunConfig
    from vae_training_tpu.data import get_dataset

    base = dict(dataset="linear_gaussian", encoder_layer_sizes="",
                layer_sizes="", latent_dimension=6, padding_dim=3,
                dataset_dimension=3, tunable_decoder_var=True)
    for name in ("linear_gaussian", "sigmoid"):
        cfg32 = RunConfig(**{**base, "dataset": name, "precision": "fp32"})
        cfg16 = RunConfig(**{**base, "dataset": name, "precision": "bf16"})
        ds32 = get_dataset(name, 2, cfg32)
        ds16 = get_dataset(name, 2, cfg16)
        assert ds32.fp32_dots and not ds16.fp32_dots
        key = jax.random.PRNGKey(7)
        np.testing.assert_array_equal(
            np.asarray(ds32.sample(key, 16)), np.asarray(ds16.sample(key, 16)))
