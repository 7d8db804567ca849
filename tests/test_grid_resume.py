"""Grid rows are individually resumable: a --seed_grid output dir's
checkpoint continues as a solo run, bit-exact with the grid's keys."""

import os

import jax
import numpy as np

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import get_dataset
from vae_training_tpu.runio import make_output_dir, restore_checkpoint
from vae_training_tpu.train import Trainer
from vae_training_tpu.train.grid import run_seed_grid


def test_grid_row_resumes_solo(tmp_path):
    data_dir = str(tmp_path)
    cfg = RunConfig(
        name="g", dataset="linear_gaussian", encoder_layer_sizes="",
        layer_sizes="", latent_dimension=6, padding_dim=3,
        dataset_dimension=3, num_batches=100, batch_size=32,
        learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True,
        overwrite=True, tqdm=False, data_dir=data_dir,
    ).validate()
    run_seed_grid(cfg, [2, 3])

    # Resume seed 3's row solo and train 50 more steps.
    row_dir = os.path.join(data_dir, "g_seed3")
    assert os.path.exists(os.path.join(row_dir, "ckpt.npz"))
    solo_cfg = RunConfig(**{**cfg.to_json_dict(),
                            "name": "g3_more", "dataset_seed": 3,
                            "num_batches": 150, "resume": row_dir}).validate()
    out = make_output_dir("g3_more", True, solo_cfg, data_dir=data_dir)
    ds = get_dataset("linear_gaussian", 3, solo_cfg)
    trainer = Trainer(solo_cfg, ds, out)
    assert int(trainer.state.step) == 100
    trainer.state, losses = trainer.fns.train_chunk(trainer.state, 50)
    assert int(trainer.state.step) == 150
    assert np.all(np.isfinite(np.asarray(losses)))


def test_grid_rejects_epoch_datasets(tmp_path):
    import pytest

    from vae_training_tpu.train.grid import GridTrainer

    cfg = RunConfig(
        name="ge", dataset="image", image_source="synthetic",
        image_size=16, num_images=64, overwrite=True, tqdm=False,
        data_dir=str(tmp_path),
    ).validate()
    with pytest.raises(NotImplementedError, match="seed_grid"):
        GridTrainer(cfg, [0, 1])
