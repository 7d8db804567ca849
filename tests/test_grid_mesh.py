"""Mesh-sharded seed grid: N devices train N× seeds with per-seed
trajectories identical to a single-device grid launch.

Runs on the 8 virtual CPU devices (conftest). Seeds are independent, so the
shard_map'd grid chunk has zero collectives — sharding must change placement
only, never math.
"""

import jax
import numpy as np
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.train.grid import GridTrainer, run_seed_grid

SEEDS = [2, 3, 4, 5, 6, 7, 8, 9]


def make_cfg(tmpdir, mesh="", dataset="linear_gaussian", **kw):
    defaults = dict(
        name="gm",
        dataset=dataset,
        encoder_layer_sizes="",
        layer_sizes="",
        latent_dimension=6,
        padding_dim=3,
        dataset_dimension=3,
        dataset_intrinsic_dimension=3,
        num_batches=100,
        batch_size=32,
        learning_rate=1e-3,
        epsilon=-1.0,
        tunable_decoder_var=True,
        overwrite=True,
        tqdm=False,
        data_dir=tmpdir,
        mesh=mesh,
    )
    defaults.update(kw)
    return RunConfig(**defaults).validate()


def per_seed_trees_equal(a, b, n, rtol=0.0, atol=0.0):
    """Per-seed comparison. On the CPU XLA path, vmap-over-all-seeds and
    shard_map(vmap-over-local-rows) reassociate the batched matmuls
    differently, so results agree to ~1 ulp per step (measured ≤7e-6 rel
    after 50 Adam steps) rather than bitwise."""
    for i in range(n):
        ta = jax.tree_util.tree_map(lambda x: np.asarray(x)[i], a)
        tb = jax.tree_util.tree_map(lambda x: np.asarray(x)[i], b)
        flat_b = {jax.tree_util.keystr(p): v
                  for p, v in jax.tree_util.tree_leaves_with_path(tb)}
        for path, val in jax.tree_util.tree_leaves_with_path(ta):
            key = jax.tree_util.keystr(path)
            np.testing.assert_allclose(
                val, flat_b[key], rtol=rtol, atol=atol,
                err_msg=f"seed row {i}: {key}")


@pytest.mark.parametrize("dp", [4, 8])
def test_sharded_grid_trajectories_match_single_device(tmp_outdir, dp):
    solo = GridTrainer(make_cfg(tmp_outdir), SEEDS)
    mesh = GridTrainer(make_cfg(tmp_outdir, mesh=f"dp={dp}"), SEEDS)

    s_grid, s_losses = solo._train_chunk(solo.dataset_grid, solo.state_grid, 50)
    m_grid, m_losses = mesh._train_chunk(mesh.dataset_grid, mesh.state_grid, 50)

    np.testing.assert_allclose(np.asarray(s_losses), np.asarray(m_losses),
                               rtol=1e-5, atol=1e-5)
    per_seed_trees_equal(s_grid.params, m_grid.params, len(SEEDS),
                         rtol=1e-4, atol=1e-6)
    per_seed_trees_equal(s_grid.opt_state, m_grid.opt_state, len(SEEDS),
                         rtol=1e-4, atol=1e-6)
    # the mesh run's state really is sharded over dp
    leaf = jax.tree_util.tree_leaves(m_grid.params)[0]
    assert len(leaf.sharding.device_set) == dp


def test_sharded_grid_sphere_mlp_config(tmp_outdir):
    """MLP (sphere-sweep) architecture through the sharded grid path."""
    kw = dict(dataset="sphere", encoder_layer_sizes="16|16",
              layer_sizes="16|16", epsilon=-3.0)
    solo = GridTrainer(make_cfg(tmp_outdir, **kw), SEEDS[:4])
    mesh = GridTrainer(make_cfg(tmp_outdir, mesh="dp=4", **kw), SEEDS[:4])
    s_grid, s_losses = solo._train_chunk(solo.dataset_grid, solo.state_grid, 20)
    m_grid, m_losses = mesh._train_chunk(mesh.dataset_grid, mesh.state_grid, 20)
    np.testing.assert_allclose(np.asarray(s_losses), np.asarray(m_losses),
                               rtol=1e-5, atol=1e-5)
    per_seed_trees_equal(s_grid.params, m_grid.params, 4,
                         rtol=1e-4, atol=1e-6)


def test_sharded_grid_end_to_end_artifacts(tmp_outdir):
    """run_seed_grid with --mesh writes every per-seed run directory."""
    import os

    cfg = make_cfg(tmp_outdir, mesh="dp=8", num_batches=30)
    rc = run_seed_grid(cfg, SEEDS)
    assert rc == 0
    for s in SEEDS:
        out = os.path.join(tmp_outdir, f"gm_seed{s}")
        files = set(os.listdir(out))
        assert {"args.json", "losses.npz", "model.pkl",
                "ckpt.npz"} <= files
        z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
        assert z["VAE Loss"].shape[0] >= 30
        assert np.all(np.isfinite(z["VAE Loss"]))


def test_mesh_grid_validation_errors(tmp_outdir):
    with pytest.raises(ValueError, match="divide evenly"):
        GridTrainer(make_cfg(tmp_outdir, mesh="dp=8"), SEEDS[:6])
    with pytest.raises(ValueError, match="tp does not apply"):
        GridTrainer(make_cfg(tmp_outdir, mesh="dp=4,tp=2"), SEEDS)
