"""Test environment: the CPU backend with 8 virtual devices, so mesh and
shard_map code is exercised without a multi-device machine (the standard
JAX fake-backend trick — SURVEY.md §4). Must run before jax is imported
anywhere."""

import os
import re

os.environ["JAX_PLATFORMS"] = "cpu"
# Force EXACTLY 8 virtual devices: an inherited flag with a different
# count (left over from another project's shell) must be replaced, not
# kept — the mesh tests assume dp=8.
_flags = os.environ.get("XLA_FLAGS", "")
_flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", _flags)
os.environ["XLA_FLAGS"] = (
    _flags + " --xla_force_host_platform_device_count=8"
).strip()

import pytest  # noqa: E402


@pytest.fixture
def tmp_outdir(tmp_path):
    return str(tmp_path)
