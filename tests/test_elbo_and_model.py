"""ELBO math against closed forms + VAE module semantics.

Checks every legacy-semantics trap from SURVEY.md §7: global epsilon_p,
ε-as-log-variance, tdv multiplicative scalar, dual sigmoid decoder,
z2 output noise in sampling mode.
"""

import jax
import jax.numpy as jnp
import numpy as np

from vae_training_tpu.models import VAE, build_vae
from vae_training_tpu.ops import elbo_terms, gaussian_nll, kl_to_standard_normal

KEY = jax.random.PRNGKey(0)


def test_kl_closed_form():
    # KL(N(0,1)||N(0,1)) = 0
    mu = jnp.zeros((4, 3))
    logvar = jnp.zeros((3,))
    np.testing.assert_allclose(np.asarray(kl_to_standard_normal(mu, logvar)),
                               np.zeros(4), atol=1e-7)
    # KL(N(m, s^2)||N(0,1)) = 0.5*(s^2 + m^2 - 1 - log s^2), per dim
    mu = jnp.array([[1.0, -2.0]])
    logvar = jnp.array([0.5, -0.3])
    expected = 0.5 * np.sum(
        np.exp([0.5, -0.3]) + np.array([1.0, 4.0]) - 1.0 - np.array([0.5, -0.3])
    )
    np.testing.assert_allclose(float(kl_to_standard_normal(mu, logvar)[0]),
                               expected, rtol=1e-6)


def test_gaussian_nll_matches_reference_formula():
    rng = np.random.RandomState(0)
    x = rng.randn(5, 7).astype(np.float32)
    x_hat = rng.randn(5, 7).astype(np.float32)
    eps = -1.3
    # reference/networks.py:96
    expected = (0.5 * (x_hat - x) ** 2 / np.exp(eps)
                + 0.5 * (np.log(2 * np.pi) + eps)).sum(-1)
    got = gaussian_nll(jnp.asarray(x), jnp.asarray(x_hat), jnp.asarray(eps))
    np.testing.assert_allclose(np.asarray(got), expected, rtol=1e-5)


def test_elbo_terms_mean_decomposition():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(8, 4), jnp.float32)
    x_hat = jnp.asarray(rng.randn(8, 4), jnp.float32)
    mu = jnp.asarray(rng.randn(8, 3), jnp.float32)
    logvar = jnp.asarray(rng.randn(3), jnp.float32)
    loss, dkl, mse = elbo_terms(x, x_hat, mu, logvar, jnp.asarray(0.2))
    np.testing.assert_allclose(float(loss), float(dkl) + float(mse), rtol=1e-5)


def _init(model, data_dim, latent_dim):
    x = jnp.zeros((1, data_dim))
    z1 = jnp.zeros((1, latent_dim))
    z2 = jnp.zeros((1, data_dim))
    return model.init(KEY, x, z1, z2)["params"]


def test_param_tree_matches_reference_names():
    model = build_vae(data_dim=5, latent_dim=3, encoder_layer_sizes="8|8",
                      decoder_layer_sizes="8", epsilon=-1.0,
                      tunable_decoder_var=True, dataset_name="sigmoid")
    params = _init(model, 5, 3)
    assert set(params) == {"Encoder", "Decoder", "SigDecoder", "epsilon_p", "epsilon"}
    assert set(params["Encoder"]) == {"FC0", "FC1", "FC2"}  # 8|8 + latent head
    assert set(params["Decoder"]) == {"FC0", "FC1"}  # 8 + data head
    assert params["epsilon_p"].shape == (3,)
    assert params["epsilon"].shape == (1,)
    np.testing.assert_array_equal(np.asarray(params["epsilon_p"]), np.ones(3))


def test_linear_vae_forward_matches_manual_math():
    """0-hidden-layer VAE forward == hand-computed affine pipeline."""
    model = build_vae(data_dim=4, latent_dim=2, encoder_layer_sizes="",
                      decoder_layer_sizes="", epsilon=-1.0,
                      tunable_decoder_var=True)
    params = _init(model, 4, 2)
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(6, 4), jnp.float32)
    z1 = jnp.asarray(rng.randn(6, 2), jnp.float32)
    z2 = jnp.asarray(rng.randn(6, 4), jnp.float32)
    x_hat, mu, logvar_e, epsilon = model.apply({"params": params}, x, z1, z2)

    We = np.asarray(params["Encoder"]["FC0"]["kernel"])
    be = np.asarray(params["Encoder"]["FC0"]["bias"])
    Wd = np.asarray(params["Decoder"]["FC0"]["kernel"])
    bd = np.asarray(params["Decoder"]["FC0"]["bias"])
    ep = np.asarray(params["epsilon_p"])
    eps = float(params["epsilon"][0]) * -1.0

    mu_ref = np.asarray(x) @ We + be
    s = mu_ref + np.exp(ep / 2) * np.asarray(z1)
    xh_ref = s @ Wd + bd + np.asarray(z2) * np.exp(eps / 2)

    np.testing.assert_allclose(np.asarray(mu), mu_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(logvar_e), ep)
    np.testing.assert_allclose(float(epsilon[0]), eps, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(x_hat), xh_ref, rtol=1e-4, atol=1e-5)


def test_tdv_off_uses_constant_epsilon():
    model = build_vae(data_dim=4, latent_dim=2, epsilon=-3.0)
    params = _init(model, 4, 2)
    assert "epsilon" not in params
    x = jnp.zeros((2, 4))
    _, _, _, epsilon = model.apply(
        {"params": params}, x, jnp.zeros((2, 2)), jnp.zeros((2, 4))
    )
    assert float(epsilon) == -3.0


def test_dual_sigmoid_decoder_sums_heads():
    model = build_vae(data_dim=4, latent_dim=4, dataset_name="sigmoid")
    params = _init(model, 4, 4)
    z1 = jnp.asarray(np.random.RandomState(0).randn(3, 4), jnp.float32)
    z2 = jnp.zeros((3, 4))
    out = model.apply({"params": params}, z1, z2, 0.0, method=VAE.generate)
    Wd = np.asarray(params["Decoder"]["FC0"]["kernel"])
    bd = np.asarray(params["Decoder"]["FC0"]["bias"])
    Ws = np.asarray(params["SigDecoder"]["FC0"]["kernel"])
    bs = np.asarray(params["SigDecoder"]["FC0"]["bias"])
    plain = np.asarray(z1) @ Wd + bd
    sig = 1 / (1 + np.exp(-(np.asarray(z1) @ Ws + bs)))
    # generate still adds z2*exp(eps/2) noise, here z2=0
    np.testing.assert_allclose(np.asarray(out), plain + sig, rtol=1e-4, atol=1e-5)


def test_generate_adds_output_noise():
    """z2 output noise is added even in ancestral-sampling mode
    (reference/networks.py:81-83)."""
    model = build_vae(data_dim=4, latent_dim=2, epsilon=0.0)
    params = _init(model, 4, 2)
    z1 = jnp.zeros((2, 2))
    z2 = jnp.ones((2, 4))
    eps = jnp.asarray(-2.0)
    out = model.apply({"params": params}, z1, z2, eps, method=VAE.generate)
    base = model.apply({"params": params}, z1, jnp.zeros((2, 4)), eps,
                       method=VAE.generate)
    np.testing.assert_allclose(
        np.asarray(out - base), np.full((2, 4), np.exp(-1.0)), rtol=1e-5
    )


def test_empty_layer_string_is_pure_linear():
    from vae_training_tpu.models import parse_layer_sizes

    assert parse_layer_sizes("") == ()
    assert parse_layer_sizes("512|512") == (512, 512)
    model = build_vae(data_dim=4, latent_dim=2, encoder_layer_sizes="",
                      decoder_layer_sizes="")
    params = _init(model, 4, 2)
    assert set(params["Encoder"]) == {"FC0"}
    assert params["Encoder"]["FC0"]["kernel"].shape == (4, 2)
    assert params["Decoder"]["FC0"]["kernel"].shape == (2, 4)


def test_fcn_optional_features():
    """FullyConnectedNetwork's optional knobs (leaky ReLU, BatchNorm,
    sigmoid head, unit-normal kernel init) — reference networks.py:26-47."""
    from vae_training_tpu.models import FullyConnectedNetwork

    x = jnp.asarray(np.random.RandomState(0).randn(16, 5), jnp.float32)

    # leaky: negative pre-activations leak by 0.1
    net = FullyConnectedNetwork((8, 3), leaky=True)
    variables = net.init(KEY, x)
    out = net.apply(variables, x)
    assert out.shape == (16, 3)

    # sigmoid head bounds outputs
    net = FullyConnectedNetwork((8, 3), sigmoid_head=True)
    out = net.apply(net.init(KEY, x), x)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0

    # batch_norm: mutable batch_stats collection exists and updates
    net = FullyConnectedNetwork((8, 8, 3), batch_norm=True)
    variables = net.init(KEY, x)
    assert "batch_stats" in variables
    out, mutated = net.apply(variables, x, mutable=["batch_stats"])
    assert out.shape == (16, 3)
    leaves = jax.tree_util.tree_leaves(mutated["batch_stats"])
    assert any(float(jnp.abs(l).sum()) > 0 for l in leaves)

    # unit-normal kernel init (reference's datasets=True): std ~ 1, not lecun
    net = FullyConnectedNetwork((256,), unit_normal_init=True)
    params = net.init(KEY, x)["params"]
    std = float(jnp.std(params["FC0"]["kernel"]))
    assert 0.8 < std < 1.2
