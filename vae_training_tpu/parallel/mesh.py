"""Device mesh construction from a CLI spec string.

The reference has no distributed support at all (SURVEY.md §2.2); scale-out
here is a ``jax.sharding.Mesh`` over which the fused train step is sharded,
with XLA compiling the collectives.

Spec grammar: comma-separated ``axis=size``, e.g. ``"dp=8"``,
``"dp=4,tp=2"``, or ``"dp_dcn=2,dp=4"``. Supported axes:

- ``dp`` — data parallel within a host: batch sharded, gradients
  all-reduced across the host's devices.
- ``tp`` — tensor parallel: MLP hidden dims sharded, activation
  collectives inserted by GSPMD.
- ``dp_dcn`` — second-level data parallelism ACROSS hosts (SURVEY §2.2).
  Always the outermost mesh axis regardless of spec order:
  ``jax.devices()`` is ordered by process, so the leading axis is the one
  whose neighbors live on different hosts — reductions over it cross the
  inter-host network, everything inside stays within a host. The dp
  gradient reduction is correspondingly hierarchical (``pmean`` over
  ``dp`` first, then over ``dp_dcn`` — only the already host-reduced
  tensor crosses hosts; parallel/dp.py).

The mesh is a reshape of ``jax.devices()``: devices within a host are all
connected to each other, so no topology-aware layout is needed.

``axis=-1`` means "all remaining devices".
"""

from __future__ import annotations

import sys
from typing import Dict

import jax
import numpy as np
from jax.sharding import Mesh

SUPPORTED_AXES = ("dp_dcn", "dp", "tp")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    axes: Dict[str, int] = {}
    if not spec:
        return axes
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"Bad mesh spec segment {part!r}; expected axis=size")
        name, size = part.split("=", 1)
        name = name.strip()
        if name not in SUPPORTED_AXES:
            raise ValueError(
                f"Unsupported mesh axis {name!r}; supported: {SUPPORTED_AXES}"
            )
        if name in axes:
            raise ValueError(f"Duplicate mesh axis {name!r} in {spec!r}")
        size = int(size)
        if size == 0 or size < -1:
            raise ValueError(
                f"Bad size for mesh axis {name}={size}; expected a positive "
                f"integer or -1 (all remaining devices)"
            )
        axes[name] = size
    return axes


def make_mesh(spec: str, devices=None, allow_uneven: bool = False) -> Mesh:
    """Build the Mesh. The result ALWAYS carries a ``dp`` axis (inserted as
    dp=1 for tp-only specs) — every sharding in parallel/{dp,gspmd}.py
    partitions the batch over ``dp``, so its presence is part of the mesh
    contract.

    A ``-1`` wildcard that cannot use every device (device count not
    divisible by the explicit axes) is an ERROR unless ``allow_uneven=True``
    (CLI: ``--mesh_allow_uneven``): silently training on k<N chips is a
    throughput loss a user must acknowledge explicitly."""
    axes = parse_mesh_spec(spec)
    if not axes:
        raise ValueError("Empty mesh spec")
    if "dp" not in axes:
        axes["dp"] = 1
    # Canonical axis order (dp_dcn, dp, tp): dp_dcn MUST lead so its rows
    # land on distinct hosts (see module docstring), and dp-before-tp keeps
    # tp groups on adjacent devices.
    axes = {n: axes[n] for n in SUPPORTED_AXES if n in axes}
    devices = list(devices if devices is not None else jax.devices())
    wildcards = [n for n, s in axes.items() if s == -1]
    if len(wildcards) > 1:
        raise ValueError(
            f"At most one mesh axis may be -1, got {wildcards} in {spec!r}"
        )
    known = int(np.prod([s for s in axes.values() if s > 0]))
    for name in wildcards:
        resolved = len(devices) // known
        if resolved < 1:
            raise ValueError(
                f"Mesh axis {name}=-1 resolves to 0: the explicit axes "
                f"{ {n: s for n, s in axes.items() if s > 0} } already need "
                f"{known} devices but only {len(devices)} are available"
            )
        if known * resolved != len(devices):
            if not allow_uneven:
                raise ValueError(
                    f"Mesh axis {name}=-1 would use only "
                    f"{known * resolved}/{len(devices)} devices "
                    f"({len(devices)} not divisible by {known}); idle chips "
                    f"are a silent throughput loss. Pass an explicit size "
                    f"or --mesh_allow_uneven to accept it."
                )
            print(
                f"[mesh] {name}=-1 -> {resolved}: using "
                f"{known * resolved}/{len(devices)} devices "
                f"({len(devices)} not divisible by {known})",
                file=sys.stderr, flush=True,
            )
        axes[name] = resolved
    total = int(np.prod(list(axes.values())))
    if total > len(devices):
        raise ValueError(
            f"Mesh {axes} needs {total} devices but only {len(devices)} available"
        )
    mesh_devices = np.array(devices[:total]).reshape(tuple(axes.values()))
    return Mesh(mesh_devices, tuple(axes.keys()))
