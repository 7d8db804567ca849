#!/usr/bin/env python
"""Trace one training chunk of a bench workload and count what the device
ran: kernel launches per step, device busy time and idle share.

    python tools/trace_step.py --config linear --steps 2000 \
        --out data/trace_linear

Builds the ``bench.py`` workload, compiles and warms its train chunk, then
records ONE chunk of ``--steps`` steps with ``jax.profiler`` inside a host
annotation named ``train_chunk``. The reduction reads the ``.xplane.pb``:
device events are those on ``/device:GPU:*`` planes that fall inside the
annotation's window; busy time is the union of their intervals; the idle
share is 1 − busy / window. Prints per-line event counts (to see how the
trace is laid out) and one JSON summary line.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def summarize(xplane_path: str, steps: int) -> dict:
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    window = None
    for plane in data.planes:
        for line in plane.lines:
            for ev in line.events:
                if ev.name == "train_chunk":
                    window = (ev.start_ns, ev.end_ns)
    if window is None:
        raise ValueError("no train_chunk annotation in the trace")
    lo, hi = window
    intervals, names = [], collections.Counter()
    durations = collections.Counter()
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in lines:
            evs = [e for e in line.events if lo <= e.start_ns <= hi]
            print(f"[trace] {plane.name} / {line.name}: {len(evs)} events",
                  file=sys.stderr)
            if streams and line not in streams:
                continue  # derived lines repeat the stream events
            for e in evs:
                intervals.append((e.start_ns, e.end_ns))
                names[e.name] += 1
                durations[e.name] += e.duration_ns
    busy = _union_ns(intervals)
    top = [{"name": n[:80], "per_step": names[n] / steps,
            "us_per_step": durations[n] / steps / 1e3}
           for n, _ in durations.most_common(12)]
    return {
        "steps": steps,
        "window_ms": (hi - lo) / 1e6,
        "us_per_step": (hi - lo) / steps / 1e3,
        "device_events_per_step": len(intervals) / steps,
        "device_busy_us_per_step": busy / steps / 1e3,
        "idle_share": 1.0 - busy / (hi - lo),
        "top_by_time": top,
    }


def main(argv=None) -> int:
    from vae_training_tpu._scripts import bench

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="linear",
                   choices=["linear", "sigmoid", "sphere"])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", required=True)
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    args = p.parse_args(argv)

    trainer = bench.build(args.config, args.precision)
    state, losses = trainer.fns.train_chunk(trainer.state, args.steps)
    jax.block_until_ready(losses)  # compile + warm
    jax.profiler.start_trace(args.out)
    with jax.profiler.TraceAnnotation("train_chunk"):
        state, losses = trainer.fns.train_chunk(state, args.steps)
        jax.block_until_ready(losses)
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(args.out, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    summary = summarize(path, args.steps)
    summary.update(config=args.config, precision=args.precision,
                   device=jax.devices()[0].device_kind)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
