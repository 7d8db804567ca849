"""End-to-end training engine tests: cadences, artifacts, and the analytic
convergence oracle (padding error → 0, per SURVEY.md §4)."""

import os

import jax
import numpy as np
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import get_dataset
from vae_training_tpu.runio import make_output_dir
from vae_training_tpu.train import Trainer


def make_cfg(tmpdir, **kw):
    defaults = dict(
        name="t",
        dataset="linear_gaussian",
        encoder_layer_sizes="",
        layer_sizes="",
        latent_dimension=8,
        padding_dim=3,
        dataset_dimension=3,
        dataset_intrinsic_dimension=3,
        num_batches=200,
        batch_size=100,
        learning_rate=1e-3,
        epsilon=-1.0,
        tunable_decoder_var=True,
        dataset_seed=2,
        overwrite=True,
        tqdm=False,
        data_dir=tmpdir,
    )
    defaults.update(kw)
    return RunConfig(**defaults)


def build_trainer(tmpdir, **kw):
    cfg = make_cfg(tmpdir, **kw).validate()
    out = make_output_dir(cfg.name, cfg.overwrite, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    return Trainer(cfg, ds, out), out


def test_artifacts_and_trace_shape(tmp_outdir):
    trainer, out = build_trainer(tmp_outdir)
    trainer.n_print = 50
    trainer.n_plot = 100
    trainer.train()
    trainer.plot()
    trainer.save(final=True)
    files = set(os.listdir(out))
    assert {"args.json", "losses.npz", "model.pkl", "ckpt.npz"} <= files
    assert "output_0.png" in files and "output_199.png" in files
    z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
    # 200 train losses + 4 evals (batches 0,50,100,150)
    assert z["VAE Loss"].shape == (204,)
    assert z["KL divergence"].shape == (4,)
    assert z["Encoder Variance"].shape == (4, 8)
    assert z["EigenValues"].shape == (2, 0)
    assert "Correlation Ratio" in z.files


def test_padding_error_decreases(tmp_outdir):
    """The analytic oracle: training must drive the generated samples'
    padding energy down (the reference's de-facto integration test)."""
    trainer, _ = build_trainer(tmp_outdir, num_batches=2000, latent_dimension=6)
    trainer.n_print = 500
    trainer.n_plot = 10**9
    first = trainer.compute_stats()
    trainer.train()
    last = trainer.compute_stats()
    key = "Squared Norm of padding dimensions"
    assert float(last[key]) < 0.5 * float(first[key])
    assert float(last["VAE Loss"]) < float(first["VAE Loss"])


def test_event_scheduler_covers_all_steps(tmp_outdir):
    trainer, _ = build_trainer(tmp_outdir, num_batches=173)
    trainer.n_print = 50
    trainer.n_plot = 100
    b, visits = 0, []
    while b < 173:
        nxt = trainer._next_event(b)
        assert nxt > b
        visits.append((b, nxt))
        b = nxt
    assert b == 173
    starts = [v[0] for v in visits]
    assert 50 in starts and 100 in starts and 172 in starts


def test_stats_console_format(tmp_outdir):
    trainer, _ = build_trainer(tmp_outdir, num_batches=10)
    stats = {"VAE Loss": 1.23456, "weird": object()}
    msg = trainer.recorder.write_stats(7, stats)
    assert msg.startswith("Batch | 7")
    assert "VAE Loss | 1.235" in msg
    assert "weird" not in msg  # non-floatable: recorded, not printed
    assert len(trainer.recorder.stats["weird"]) == 1  # no double-append


def test_eval_updates_current_epsilon(tmp_outdir):
    trainer, _ = build_trainer(tmp_outdir, num_batches=10)
    assert trainer.current_epsilon == -1.0
    trainer.compute_stats()
    # tdv: epsilon becomes the learned (1,) array = scale * const
    assert np.asarray(trainer.current_epsilon).shape == (1,)
    np.testing.assert_allclose(np.asarray(trainer.current_epsilon), [-1.0])


def test_correlation_tracking(tmp_outdir):
    cfg = make_cfg(tmp_outdir).validate()
    out = make_output_dir(cfg.name, cfg.overwrite, cfg, data_dir=cfg.data_dir)
    ds = get_dataset(cfg.dataset, cfg.dataset_seed, cfg)
    trainer = Trainer(cfg, ds, out, track_correlation=True)
    trainer.n_print = 100
    trainer.n_plot = 10**9
    trainer.train()
    trainer.save(final=True)
    z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
    cr = z["Correlation Ratio"]
    assert cr.shape == (2,)  # evals at 0 and 100
    assert np.all(np.isfinite(cr))
    # per-parameter granularity (reference/vae.py:149-177): one
    # channel per param leaf, one value per eval
    per_param = [k for k in z.files if k.startswith("Correlation Ratio/")]
    leaves = {"Correlation Ratio/Encoder/FC0/kernel",
              "Correlation Ratio/Encoder/FC0/bias",
              "Correlation Ratio/Decoder/FC0/kernel",
              "Correlation Ratio/Decoder/FC0/bias",
              "Correlation Ratio/epsilon_p",
              "Correlation Ratio/epsilon"}
    assert set(per_param) == leaves
    for k in per_param:
        assert z[k].shape == (2,)


def test_correlation_ratio_per_param_hand_computed():
    """Two-parameter example checked by hand: each leaf's ratio is its own
    -<g, d>/||d||^2, and the whole-tree ratio pools numerators/denominators."""
    from vae_training_tpu.utils import (
        correlation_ratio,
        correlation_ratio_per_param,
    )

    params = {"a": np.array([1.0, 2.0]), "b": np.array([[3.0]])}
    opt = {"a": np.array([2.0, 4.0]), "b": np.array([[2.0]])}
    grads = {"a": np.array([0.5, -1.0]), "b": np.array([[4.0]])}
    # d_a = [1, 2], <g_a, d_a> = 0.5 - 2 = -1.5, ||d_a||^2 = 5 → ratio 0.3
    # d_b = [-1],   <g_b, d_b> = -4,             ||d_b||^2 = 1 → ratio 4.0
    per = correlation_ratio_per_param(opt, params, grads)
    np.testing.assert_allclose(float(per["a"]), 0.3, rtol=1e-6)
    np.testing.assert_allclose(float(per["b"]), 4.0, rtol=1e-6)
    # pooled: -(-1.5 + -4) / (5 + 1) = 5.5/6
    np.testing.assert_allclose(
        float(correlation_ratio(opt, params, grads)), 5.5 / 6, rtol=1e-6
    )
