"""The framework's CLI implementations (run/sweep/bench/sample and the
shared child-process supervisor).

These are the modules the console entry points (``vae-train``,
``vae-sweep``, ``vae-bench``, ``vae-sample``) target. The repo-root
``run.py``/``sweep.py``/``bench.py``/``sample.py``/``_supervise.py`` are
thin aliases onto them, kept so the reference's script-invocation surface
(``python run.py ...``, reference/run.py) works verbatim from a
checkout — while an INSTALLED wheel claims no generic top-level module
names (``import run`` must not resolve to this package in a shared
environment)."""
