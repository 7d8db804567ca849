"""What the GPU bring-up added that runs without a GPU: the compile-cache
location rule, the benchmark's peak table, the refusal to measure or smoke
test on a CPU, and a training run with the optional packages absent."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

import bench
from vae_training_tpu import runio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_dir_rule(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: the program sets no directory (jax
    reads the variable itself). Unset: one fixed, git-ignored directory in
    the checkout."""
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert runio.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert runio.compile_cache_dir() is None


@pytest.mark.parametrize("kind,precision,peak", [
    ("NVIDIA H100 80GB HBM3", "bf16", 494.5e12),
    ("NVIDIA H100 80GB HBM3", "fp32", 67e12),
    ("NVIDIA H100 PCIe", "bf16", 378e12),
])
def test_h100_peak_lookup(kind, precision, peak):
    assert bench.device_peak_flops(kind, precision) == peak


def test_unknown_device_kind_has_no_peak(capsys):
    assert bench.device_peak_flops("cpu", "bf16") is None
    assert "'cpu'" in capsys.readouterr().err


def test_bench_refuses_to_measure_the_cpu(capsys):
    assert bench.main(["--config", "linear"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "platform 'cpu'" in err


def test_chip_smoke_fails_on_cpu():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "platform 'cpu'" in res.stderr
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout


BLOCKED_RUN = textwrap.dedent("""
    import sys
    for name in ("flax", "msgpack", "matplotlib", "tqdm"):
        sys.modules[name] = None  # any import of them raises ImportError
    from vae_training_tpu._scripts.run import main
    from vae_training_tpu.config import RunConfig
    base = dict(name="blocked", dataset="sphere", encoder_layer_sizes="8",
                layer_sizes="8", latent_dimension=4, padding_dim=2,
                dataset_dimension=3, num_batches=40, batch_size=16,
                epsilon=-3.0, tunable_decoder_var=True, n_print=20,
                n_plot=20, data_dir=sys.argv[1])
    assert main(RunConfig(**base, overwrite=True)) == 0
    resumed = RunConfig(**{**base, "num_batches": 60,
                           "resume": sys.argv[1] + "/blocked"})
    assert main(resumed) == 0
""")


def test_training_runs_without_optional_packages(tmp_path):
    """flax, msgpack, matplotlib and tqdm blocked: a run trains, evaluates,
    checkpoints and resumes; plot events are skipped with one note."""
    res = subprocess.run(
        [sys.executable, "-c", BLOCKED_RUN, str(tmp_path)], cwd=REPO,
        env=_cpu_env(PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = tmp_path / "blocked"
    files = set(os.listdir(out))
    assert {"args.json", "losses.npz", "model.pkl", "ckpt.npz"} <= files
    assert not any(f.endswith(".png") for f in files)
    assert res.stderr.count("matplotlib is not installed") == 1
    with open(out / "ckpt_meta.json") as f:
        assert json.load(f)["step"] == 60
