"""Vmapped multi-seed grid training: per-seed parity with solo runs,
artifacts, and convergence."""

import os

import jax
import numpy as np
import pytest

from vae_training_tpu.config import RunConfig
from vae_training_tpu.data import get_dataset
from vae_training_tpu.runio import make_output_dir
from vae_training_tpu.train import Trainer
from vae_training_tpu.train.grid import GridTrainer, run_seed_grid


def make_cfg(tmpdir, **kw):
    defaults = dict(
        name="grid",
        dataset="linear_gaussian",
        encoder_layer_sizes="",
        layer_sizes="",
        latent_dimension=6,
        padding_dim=3,
        dataset_dimension=3,
        num_batches=120,
        batch_size=40,
        learning_rate=1e-3,
        epsilon=-1.0,
        tunable_decoder_var=True,
        overwrite=True,
        tqdm=False,
        data_dir=tmpdir,
    )
    defaults.update(kw)
    return RunConfig(**defaults).validate()


def test_grid_trains_and_converges(tmp_outdir):
    cfg = make_cfg(tmp_outdir, num_batches=600)
    trainer = GridTrainer(cfg, seeds=[2, 3, 4])
    trainer.compute_and_write_stats()
    first = [float(r.vae_losses[0][0]) for r in trainer.recorders]
    trainer.state_grid, losses = trainer._train_chunk(
        trainer.dataset_grid, trainer.state_grid, 600
    )
    assert losses.shape == (3, 600)
    trainer.batchnum = 600
    trainer.compute_and_write_stats()
    last = [float(r.vae_losses[-1][0]) for r in trainer.recorders]
    for f, l in zip(first, last):
        assert l < f  # every seed converging


def test_grid_cli_writes_per_seed_outputs(tmp_outdir):
    from run import main

    cfg = make_cfg(tmp_outdir, seed_grid="2,3")
    assert main(cfg) == 0
    for seed in (2, 3):
        out = os.path.join(tmp_outdir, f"grid_seed{seed}")
        files = set(os.listdir(out))
        assert {"args.json", "losses.npz", "model.pkl"} <= files
        z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
        assert z["VAE Loss"].shape[0] >= cfg.num_batches
        assert np.all(np.isfinite(z["VAE Loss"]))
    # different seeds ⇒ different manifolds ⇒ different traces
    za = np.load(os.path.join(tmp_outdir, "grid_seed2", "losses.npz"),
                 allow_pickle=True)
    zb = np.load(os.path.join(tmp_outdir, "grid_seed3", "losses.npz"),
                 allow_pickle=True)
    assert not np.allclose(za["VAE Loss"][:50], zb["VAE Loss"][:50])


def test_grid_seed_matches_solo_run(tmp_outdir):
    """A seed's trajectory inside the grid equals a solo XLA run with the
    SAME FLAGS — no key surgery needed since grid rows natively share the
    solo Trainer's key derivation (vmap changes batching, not math)."""
    cfg = make_cfg(tmp_outdir, num_batches=80)
    grid = GridTrainer(cfg, seeds=[5, 7])
    grid.state_grid, glosses = grid._train_chunk(
        grid.dataset_grid, grid.state_grid, 80
    )

    solo_cfg = make_cfg(tmp_outdir, name="solo", dataset_seed=5)
    out = make_output_dir("solo", True, solo_cfg, data_dir=tmp_outdir)
    ds = get_dataset("linear_gaussian", 5, solo_cfg)
    trainer = Trainer(solo_cfg, ds, out)
    trainer.state, slosses = trainer.fns.train_chunk(trainer.state, 80)

    np.testing.assert_allclose(
        np.asarray(glosses[0]), np.asarray(slosses), rtol=1e-5, atol=1e-5
    )


def test_grid_resume_artifacts_equal_uninterrupted(tmp_outdir):
    """A preempted + resumed grid sweep emits per-seed losses.npz files
    IDENTICAL to an uninterrupted sweep's (per-row checkpoints carry the
    recorder history + shared host key chain)."""
    seeds = [2, 3]

    def drive(data_dir, die_at=None):
        cfg = make_cfg(data_dir, num_batches=400, n_print=100, n_plot=200)
        trainer = GridTrainer(cfg, seeds)
        outdirs = []
        for s in seeds:
            sub = cfg.__class__(**{**cfg.to_json_dict()})
            sub.dataset_seed = s
            outdirs.append(make_output_dir(f"grid_seed{s}", True, sub,
                                           data_dir=data_dir))
        if die_at is not None:
            orig = trainer.compute_and_write_stats

            def dying_stats():
                if trainer.batchnum == die_at:
                    raise KeyboardInterrupt
                orig()

            trainer.compute_and_write_stats = dying_stats
            with pytest.raises(KeyboardInterrupt):
                trainer.train(outdirs)
            return cfg, outdirs
        trainer.train(outdirs)
        trainer.save_all(outdirs, final=True)
        return cfg, outdirs

    dir_a = os.path.join(tmp_outdir, "straight")
    dir_b = os.path.join(tmp_outdir, "preempted")
    _, outs_a = drive(dir_a)
    # Killed at the b=300 eval: the last checkpoint is the sync save at 200
    # (events at 200 already fired).
    cfg_b, outs_b = drive(dir_b, die_at=300)

    # Resume the whole grid in place and finish.
    cfg_b.resume = "rows"
    resumed = GridTrainer(cfg_b, seeds)
    resumed.restore(outs_b)
    assert resumed.batchnum == 200
    assert resumed._skip_events_at == 200
    resumed.train(outs_b)
    resumed.save_all(outs_b, final=True)

    for oa, ob in zip(outs_a, outs_b):
        za = np.load(os.path.join(oa, "losses.npz"), allow_pickle=True)
        zb = np.load(os.path.join(ob, "losses.npz"), allow_pickle=True)
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(
                np.asarray(za[k], dtype=np.float64),
                np.asarray(zb[k], dtype=np.float64), err_msg=k)


def test_grid_rows_match_solo_run_artifacts(tmp_outdir):
    """A --seed_grid launch must produce the SAME artifacts as per-process
    solo runs: grid rows share the solo Trainer's PRNGKey(model_seed) chain
    (init params, z/eval-generation streams) and derive per-row data/eval
    streams from the dataset seed, so every losses.npz channel matches a
    solo run of the same flags. vmap batching reassociates float sums, so
    values agree to tolerance rather than bitwise."""
    from run import main

    seeds = [2, 3]
    kw = dict(num_batches=120, n_print=40, n_plot=80)
    # solo runs, one per seed (the reference's sweep shape)
    for s in seeds:
        cfg = make_cfg(tmp_outdir, name=f"solo_s{s}", dataset_seed=s, **kw)
        assert main(cfg) == 0
    # one grid launch over both seeds
    run_seed_grid(make_cfg(tmp_outdir, name="g", **kw), seeds)

    for s in seeds:
        za = np.load(os.path.join(tmp_outdir, f"solo_s{s}", "losses.npz"),
                     allow_pickle=True)
        zb = np.load(os.path.join(tmp_outdir, f"g_seed{s}", "losses.npz"),
                     allow_pickle=True)
        assert set(za.files) == set(zb.files)
        for k in za.files:
            a = np.asarray(za[k], np.float64)
            b = np.asarray(zb[k], np.float64)
            if a.size == 0:
                continue
            np.testing.assert_allclose(
                a, b, rtol=2e-3, atol=2e-4,
                err_msg=f"seed {s} channel {k}")


def test_grid_resume_reconstructs_eval_counter_without_field(tmp_outdir):
    """Pre-round-3 checkpoints lack the aux 'eval_counter' field; the
    fallback must reconstruct banner + one per recorded EVAL. Counting
    vae_losses would overshoot — it interleaves train-chunk entries with
    the eval scalars (evals/stats.py:33) — and every post-resume eval key
    would diverge from an uninterrupted run's."""
    import pickle

    from vae_training_tpu.runio.outdir import make_output_dir as mko

    seeds = [2, 3]
    cfg = make_cfg(tmp_outdir, num_batches=400, n_print=100, n_plot=200)
    trainer = GridTrainer(cfg, seeds)
    outdirs = [mko(f"grid_seed{s}", True, cfg, data_dir=tmp_outdir)
               for s in seeds]
    trainer.train(outdirs)
    true_counter = trainer._eval_counter
    assert true_counter == 1 + len(trainer.recorders[0].var_enc)

    for out in outdirs:
        p = os.path.join(out, "ckpt_aux.pkl")
        with open(p, "rb") as f:
            aux = pickle.load(f)
        del aux["eval_counter"]
        with open(p, "wb") as f:
            pickle.dump(aux, f)

    cfg.resume = "rows"
    resumed = GridTrainer(cfg, seeds)
    resumed.restore(outdirs)
    # the last in-loop save (b=399 plot event) saw the banner(1) + evals
    # at 0/100/200/300 (counters 2-5); vae_losses-based reconstruction
    # would have returned 9 (4 train chunks interleaved)
    assert resumed._eval_counter == true_counter == 5
    assert len(resumed.recorders[0].var_enc) == 4
    assert len(resumed.recorders[0].vae_losses) > 5  # would overcount


def test_grid_warm_start_states_equal_solo(tmp_outdir):
    """Warm-started grid rows carry the solo Trainer's exact warm-start
    params: the jitted one-program construction (host pinv precomputed per
    row, surgery + state assembly vmapped) must reproduce the solo path's
    eager apply_warm_start draws for every seed."""
    seeds = [2, 3]
    kw = dict(warm_start=True, latent_off_dimension=1,
              latent_dimension=6, padding_dim=3, dataset_dimension=3)
    grid = GridTrainer(make_cfg(tmp_outdir, name="ws", **kw), seeds)
    for i, s in enumerate(seeds):
        cfg = make_cfg(tmp_outdir, name=f"ws_s{s}", dataset_seed=s, **kw)
        out = make_output_dir(cfg.name, True, cfg, data_dir=tmp_outdir)
        solo = Trainer(cfg, get_dataset(cfg.dataset, s, cfg), out)
        flat_solo = {jax.tree_util.keystr(p): v for p, v in
                     jax.tree_util.tree_leaves_with_path(solo.state.params)}
        row_params = jax.tree_util.tree_map(
            lambda x: np.asarray(x)[i], grid.state_grid.params)
        for path, val in jax.tree_util.tree_leaves_with_path(row_params):
            np.testing.assert_allclose(
                val, np.asarray(flat_solo[jax.tree_util.keystr(path)]),
                rtol=1e-6, atol=1e-7,
                err_msg=f"seed {s} {jax.tree_util.keystr(path)}")


def test_grid_banner_matches_solo_scores(tmp_outdir, capsys):
    """The one-jitted-call banner grid reports the SAME per-seed scores the
    solo engine's banner would (same eval-key consumption — counter value 1
    off the fold_in(PRNGKey(seed), 2) root — and same score math), and the
    banner fires exactly once per fresh start."""
    seeds = [2, 3]
    grid = GridTrainer(make_cfg(tmp_outdir, name="bn"), seeds)
    scores = grid.maybe_print_banner()
    txt = capsys.readouterr().out
    assert scores is not None and len(scores) == len(seeds)
    for i, s in enumerate(seeds):
        assert f"[seed {s}] Score for real data:" in txt
        cfg = make_cfg(tmp_outdir, name=f"bn_s{s}", dataset_seed=s)
        out = make_output_dir(cfg.name, True, cfg, data_dir=tmp_outdir)
        solo = Trainer(cfg, get_dataset(cfg.dataset, s, cfg), out)
        batch = solo.dataset.sample(
            solo._next_eval_data_key(), solo.eval_batch_size)
        if getattr(solo.dataset, "score_on_host", False):
            expected = solo.dataset.score_host(np.asarray(batch))
        else:
            expected = jax.device_get(solo.fns.score(batch))
        assert set(scores[i]) == set(expected)
        for k in expected:
            np.testing.assert_allclose(
                np.asarray(scores[i][k]), np.asarray(expected[k]),
                rtol=1e-5, atol=1e-6, err_msg=f"seed {s} channel {k}")
    # a second call (or a resumed start) must not re-consume the eval key
    assert grid.maybe_print_banner() is None
    assert grid._eval_counter == 1


def test_grid_states_equal_solo_trainer_states(tmp_outdir):
    """The key-derivation parity itself, asserted EXACTLY: grid row i's
    initial params / model_key / data_key and the host eval chain equal the
    solo Trainer's for the same flags."""
    from vae_training_tpu.data import get_dataset
    from vae_training_tpu.runio import make_output_dir
    from vae_training_tpu.train import Trainer

    seeds = [2, 3]
    grid = GridTrainer(make_cfg(tmp_outdir, name="kp"), seeds)
    for i, s in enumerate(seeds):
        cfg = make_cfg(tmp_outdir, name=f"kp_s{s}", dataset_seed=s)
        out = make_output_dir(cfg.name, True, cfg, data_dir=tmp_outdir)
        solo = Trainer(cfg, get_dataset(cfg.dataset, s, cfg), out)
        row_params = jax.tree_util.tree_map(
            lambda x: np.asarray(x)[i], grid.state_grid.params)
        flat_solo = {jax.tree_util.keystr(p): v for p, v in
                     jax.tree_util.tree_leaves_with_path(solo.state.params)}
        for path, val in jax.tree_util.tree_leaves_with_path(row_params):
            np.testing.assert_array_equal(
                val, np.asarray(flat_solo[jax.tree_util.keystr(path)]),
                err_msg=f"seed {s} {jax.tree_util.keystr(path)}")
        np.testing.assert_array_equal(
            np.asarray(grid.state_grid.model_key)[i],
            np.asarray(solo.state.model_key), err_msg=f"seed {s} model_key")
        np.testing.assert_array_equal(
            np.asarray(grid.state_grid.data_key)[i],
            np.asarray(solo.state.data_key), err_msg=f"seed {s} data_key")
        np.testing.assert_array_equal(
            np.asarray(grid._host_key), np.asarray(solo.key),
            err_msg="host chain")
        np.testing.assert_array_equal(
            np.asarray(grid._eval_data_roots)[i],
            np.asarray(solo._eval_data_root), err_msg=f"seed {s} eval root")


@pytest.mark.slow  # two full 400-step sweeps + resume e2e (~60 s on 1 core)
def test_grid_restore_rolls_back_skewed_row(tmp_outdir):
    """SIGKILL skew (multihost preemption): one row's newest checkpoint is
    a save event ahead of the rest of the grid. restore() must roll it back
    to its retained .prev checkpoint at the grid's common step, PROMOTE the
    .prev trio (so the discarded newer step can't wedge the save ordering
    guard), and the finished run's artifacts must equal an uninterrupted
    sweep's."""
    from vae_training_tpu.runio.checkpoint import (
        CKPT_NAME,
        PREV_SUFFIX,
        read_checkpoint_meta,
        restore_checkpoint,
        save_checkpoint,
    )
    from vae_training_tpu.train.grid import fetch_grid_rows

    seeds = [2, 3]

    def drive(data_dir, die_at=None):
        cfg = make_cfg(data_dir, num_batches=400, n_print=100, n_plot=200)
        trainer = GridTrainer(cfg, seeds)
        outdirs = []
        for s in seeds:
            sub = cfg.__class__(**{**cfg.to_json_dict()})
            sub.dataset_seed = s
            outdirs.append(make_output_dir(f"grid_seed{s}", True, sub,
                                           data_dir=data_dir))
        if die_at is not None:
            orig = trainer.compute_and_write_stats

            def dying_stats():
                if trainer.batchnum == die_at:
                    raise KeyboardInterrupt
                orig()

            trainer.compute_and_write_stats = dying_stats
            with pytest.raises(KeyboardInterrupt):
                trainer.train(outdirs)
            return cfg, outdirs
        trainer.train(outdirs)
        trainer.save_all(outdirs, final=True)
        return cfg, outdirs

    dir_a = os.path.join(tmp_outdir, "straight")
    dir_b = os.path.join(tmp_outdir, "skewed")
    _, outs_a = drive(dir_a)
    cfg_b, outs_b = drive(dir_b, die_at=300)  # durable saves at step 200

    # Fabricate the skew the kill produces: row 0's owner flushed the NEXT
    # save event (step 400) before dying, row 1's didn't.
    cfg_b.resume = "rows"
    resumed = GridTrainer(cfg_b, seeds)
    template = fetch_grid_rows(resumed.state_grid, [0], len(seeds))[0]
    row0 = restore_checkpoint(outs_b[0], template)
    assert int(row0.step) == 200
    save_checkpoint(outs_b[0], row0.replace(step=400))
    assert read_checkpoint_meta(outs_b[0])["step"] == 400
    assert read_checkpoint_meta(outs_b[0], prev=True)["step"] == 200

    resumed.restore(outs_b)
    assert resumed.batchnum == 200
    assert resumed._skip_events_at == 200
    # the rolled-back row's .prev trio was promoted to CURRENT
    assert read_checkpoint_meta(outs_b[0])["step"] == 200
    assert not os.path.exists(
        os.path.join(outs_b[0], CKPT_NAME + PREV_SUFFIX))

    resumed.train(outs_b)
    resumed.save_all(outs_b, final=True)

    for oa, ob in zip(outs_a, outs_b):
        za = np.load(os.path.join(oa, "losses.npz"), allow_pickle=True)
        zb = np.load(os.path.join(ob, "losses.npz"), allow_pickle=True)
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(
                np.asarray(za[k], dtype=np.float64),
                np.asarray(zb[k], dtype=np.float64), err_msg=k)
    # post-rollback saves landed: the resumed run's final checkpoint step
    # is the run length, not the discarded 400
    assert read_checkpoint_meta(outs_b[0])["step"] == 400  # final save at num_batches


def test_grid_rejects_orbax_backend(tmp_outdir):
    """--ckpt_backend orbax must not be silently dropped to npz by the
    grid (rows checkpoint through the retention-capable npz path)."""
    cfg = make_cfg(tmp_outdir, ckpt_backend="orbax")
    with pytest.raises(NotImplementedError, match="npz"):
        GridTrainer(cfg, seeds=[2, 3])
