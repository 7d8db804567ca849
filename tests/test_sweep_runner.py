"""sweep.py: grid definitions, argv rendering, and the isolated runner."""

import os
import sys

import numpy as np
import pytest

import sweep as sweep_mod
from vae_training_tpu.config import parse_arguments


def test_grids_match_reference_row_counts():
    cfgs = list(sweep_mod.sweep_configs("linear", "d", None))
    assert len(cfgs) == 21  # 3 seeds × 7 rows (seed_linpadding_expts.sh)
    assert cfgs[0].name == "vae3linear_gaussian_12dim2"
    assert cfgs[0].learning_rate == 1e-3 and cfgs[0].num_batches == 100000
    cfgs = list(sweep_mod.sweep_configs("sigmoid", "d", None))
    assert len(cfgs) == 18
    assert cfgs[0].name == "sigmoid_dd3_pd3_ld_6_eps-3"
    assert cfgs[-1].name == "sigmoid_dd7_pd20_ld_24_eps-3_seed48"
    cfgs = list(sweep_mod.sweep_configs("sphere", "d", None))
    assert len(cfgs) == 15
    assert cfgs[0].encoder_layer_sizes == "200|200|200"


def test_cfg_to_argv_roundtrips_through_parser():
    cfg = next(sweep_mod.sweep_configs("linear", "dd", 123))
    argv = sweep_mod.cfg_to_argv(cfg)
    parsed = parse_arguments(argv)
    for field in ("name", "dataset", "encoder_layer_sizes", "layer_sizes",
                  "latent_dimension", "padding_dim", "dataset_dimension",
                  "num_batches", "batch_size", "epsilon", "dataset_seed",
                  "learning_rate", "data_dir", "adam_dtype",
                  "tunable_decoder_var", "overwrite"):
        assert getattr(parsed, field) == getattr(cfg, field), field


@pytest.mark.slow
def test_isolated_runner_success_and_failure(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    monkeypatch.chdir(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from vae_training_tpu.config import RunConfig

    cfg = RunConfig(
        name="iso", dataset="linear_gaussian", encoder_layer_sizes="",
        layer_sizes="", latent_dimension=6, padding_dim=3,
        dataset_dimension=3, num_batches=100, batch_size=32,
        learning_rate=1e-3, epsilon=-1.0, tunable_decoder_var=True,
        dataset_seed=2, overwrite=True, tqdm=False, data_dir=str(tmp_path),
    )
    assert sweep_mod.run_isolated(cfg, timeout=180, retries=0)
    z = np.load(os.path.join(str(tmp_path), "iso", "losses.npz"),
                allow_pickle=True)
    assert z["VAE Loss"].shape[0] >= 100

    # A crashing row (bad dataset) fails after retries without raising.
    bad = RunConfig(**{**cfg.to_json_dict(), "name": "bad",
                       "dataset": "4gaussian"})
    assert not sweep_mod.run_isolated(bad, timeout=120, retries=1)


def _patch_isolated_child(monkeypatch, code):
    """Make run_isolated spawn ``python -c code`` instead of run.py."""
    import subprocess

    real_popen = subprocess.Popen

    def fake_popen(argv, **kwargs):
        return real_popen([sys.executable, "-u", "-c", code], **kwargs)

    monkeypatch.setattr(subprocess, "Popen", fake_popen)


@pytest.mark.slow  # wall-clock child deadline test
def test_isolated_runner_started_child_gets_full_timeout(
        tmp_path, monkeypatch, capfd):
    """A row that outlives its wall-clock limit is killed and reported;
    its output is forwarded live."""
    _patch_isolated_child(
        monkeypatch,
        "import time; print('banner', flush=True); time.sleep(300)")
    cfg = next(sweep_mod.sweep_configs("linear", str(tmp_path), 10))
    assert not sweep_mod.run_isolated(cfg, timeout=8, retries=0)
    out, err = capfd.readouterr()
    assert "banner" in out          # child stdout is forwarded live
    assert "run exceeded" in err    # the row's wall-clock limit fired


def test_grouped_sweep_runs_rows_as_grids(tmp_path, monkeypatch):
    """--grouped groups each row's seeds into one grid launch with
    reference run names."""
    import sweep as sweep_mod

    # shrink the grid to one row to keep the test fast
    monkeypatch.setattr(sweep_mod, "LINEAR_GRID", [(3, 9, 20)])
    rc = sweep_mod.run_grouped("linear", str(tmp_path), 60)
    assert rc == 0
    for seed in (2, 3, 4):
        out = os.path.join(str(tmp_path), f"vae3linear_gaussian_12dim{seed}")
        assert os.path.exists(os.path.join(out, "losses.npz")), out
        z = np.load(os.path.join(out, "losses.npz"), allow_pickle=True)
        assert np.isfinite(z["VAE Loss"]).all()

def test_report_summarizes_artifacts(tmp_path, monkeypatch, capsys):
    """--report reads a finished sweep's artifacts and prints the per-row
    convergence table PARITY's reproduction section is built from."""
    monkeypatch.setattr(sweep_mod, "LINEAR_GRID", [(3, 9, 20)])
    assert sweep_mod.run_grouped("linear", str(tmp_path), 60) == 0
    assert sweep_mod.run_report("linear", str(tmp_path)) == 0
    out = capsys.readouterr().out
    for seed in (2, 3, 4):
        assert f"vae3linear_gaussian_12dim{seed}" in out
    assert "/3 rows converged" in out
    # a missing row is reported and flips the exit code
    import shutil
    shutil.rmtree(os.path.join(str(tmp_path), "vae3linear_gaussian_12dim3"))
    assert sweep_mod.run_report("linear", str(tmp_path)) == 1
    assert "MISSING" in capsys.readouterr().out


def test_shard_parsing_and_partition():
    assert sweep_mod.parse_shard("") == (0, 1)
    assert sweep_mod.parse_shard("0/4") == (0, 4)
    assert sweep_mod.parse_shard("3/4") == (3, 4)
    for bad in ("4/4", "-1/2", "2", "a/b"):
        with pytest.raises(SystemExit):
            sweep_mod.parse_shard(bad)
    # round-robin partition: disjoint, order-preserving, exhaustive
    items = list(range(21))
    parts = [sweep_mod.shard_items(items, (k, 3)) for k in range(3)]
    assert sorted(sum(parts, [])) == items
    assert all(not set(a) & set(b)
               for i, a in enumerate(parts) for b in parts[i + 1:])
    # every config of the linear sweep lands in exactly one shard
    cfgs = list(sweep_mod.sweep_configs("linear", "d", None))
    names = [c.name for c in cfgs]
    got = sum((
        [c.name for c in sweep_mod.shard_items(cfgs, (k, 4))]
        for k in range(4)), [])
    assert sorted(got) == sorted(names)


@pytest.mark.slow
def test_grouped_sweep_shards_cover_disjoint_row_groups(tmp_path, capsys):
    """--shard K/N with --grouped: the shards' run directories are disjoint
    and their union equals the full 21-run linear sweep — the multi-host
    sweep shape (N independent processes, zero collectives)."""
    full = {c.name for c in sweep_mod.sweep_configs("linear", "x", 60)}
    seen = set()
    for k in range(2):
        rc = sweep_mod.run_grouped("linear", str(tmp_path), 60,
                                   shard=(k, 2))
        assert rc == 0
        dirs = {d for d in os.listdir(tmp_path)
                if os.path.isdir(os.path.join(tmp_path, d))}
        new = dirs - seen
        assert new, f"shard {k} trained nothing"
        for d in new:
            assert os.path.exists(os.path.join(tmp_path, d, "losses.npz")), d
        seen = dirs
    assert seen == full
