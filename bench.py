#!/usr/bin/env python
"""Training-throughput benchmark CLI — alias onto
vae_training_tpu._scripts.bench (see run.py's shim note)."""
import sys

from vae_training_tpu._scripts import bench as _impl

sys.modules[__name__] = _impl

if __name__ == "__main__":
    sys.exit(_impl.main())
