"""Packaging smoke test.

The framework installs as a library (``pip install -e .``) with console
entry points (``vae-train``/``vae-sweep``/``vae-bench``/``vae-sample``)
targeting ``vae_training_tpu._scripts``; the repo-root scripts keep
working verbatim as the public API from a checkout (they alias the same
modules, so ``vae-train`` IS ``python run.py``) and the wheel claims no
generic top-level module names. The
install goes into an isolated ``--prefix`` so the test never mutates the
ambient environment, and ``--no-deps --no-build-isolation`` keeps it fully
offline (every dependency is already installed).
"""

import os
import site
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_pip_editable_install_and_entry_points(tmp_path):
    # A real venv (not --prefix): editable installs hook imports via a
    # .pth file, which only site directories process — the venv's own
    # site-packages is one. The ambient interpreter may itself be a venv
    # (e.g. a virtualenv), so --system-site-packages would expose the
    # BASE python, not the env holding setuptools/jax — thread the ambient
    # site-packages through PYTHONPATH instead. --no-deps + --no-build-
    # isolation keep pip fully offline.
    venv_dir = tmp_path / "venv"
    r = subprocess.run(
        [sys.executable, "-m", "venv", str(venv_dir)],
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, f"venv creation failed:\n{r.stderr[-3000:]}"
    bin_dir = venv_dir / "bin"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(site.getsitepackages())
    r = subprocess.run(
        [str(bin_dir / "python"), "-m", "pip", "install", "-e", ".",
         "--no-build-isolation", "--no-deps",
         "--quiet", "--disable-pip-version-check", "--no-input"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, f"pip install -e . failed:\n{r.stderr[-3000:]}"
    # entry-point scripts resolve and print their real --help
    cases = [
        (["vae-train", "--help"], "--num_batches"),
        (["vae-sweep", "--help"], "sweep"),
        (["vae-sample", "--help"], "sample"),
        (["vae-bench", "--help"], "--config"),
    ]
    for argv, needle in cases:
        script = bin_dir / argv[0]
        assert script.exists(), f"entry point {argv[0]} not installed"
        out = subprocess.run(
            [str(script), *argv[1:]], env=env, capture_output=True,
            text=True, timeout=300, cwd=str(tmp_path),
        )
        assert out.returncode == 0, (argv, out.stderr[-2000:])
        assert needle in out.stdout, (argv, out.stdout[:2000])
    # the installed package (incl. the CLI implementations) is importable
    # from a clean interpreter — and the install claims NO generic
    # top-level module names: `import run` must fail away from a checkout
    # (editable installs map only vae_training_tpu*)
    out = subprocess.run(
        [str(bin_dir / "python"), "-c",
         "import vae_training_tpu\n"
         "from vae_training_tpu._scripts import run, sweep, bench, sample\n"
         "try:\n"
         "    import importlib; importlib.import_module('run')\n"
         "except ImportError:\n"
         "    print('import-ok')\n"
         "else:\n"
         "    print('generic-name-leaked')"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "import-ok" in out.stdout, out.stdout[-2000:]
