#!/usr/bin/env python
"""Public CLI, reference flag surface (reference/run.py) — alias onto
vae_training_tpu._scripts.run so `python run.py ...` and `from run import
main` work verbatim from a checkout while the installed wheel claims no
top-level `run` module."""
import sys

from vae_training_tpu._scripts import run as _impl

sys.modules[__name__] = _impl

if __name__ == "__main__":
    sys.exit(_impl.cli())
