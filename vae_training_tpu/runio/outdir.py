"""Output directory management + args.json run manifest.

Reference: reference/utils.py:46-65. Differences (deliberate fixes per
SURVEY.md §7 quirk table): ``-ow`` recursively clears the directory (the
reference's per-file ``os.remove`` crashes on subdirectories), and the data
root is configurable (reference hardcodes ``data/``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys


def get_output_dir(name: str, data_dir: str = "data") -> str:
    return os.path.join(data_dir, name)


def make_output_dir(name: str, overwrite: bool, cfg, data_dir: str = "data",
                    reuse_existing: bool = False) -> str:
    dirname = get_output_dir(name, data_dir)
    from ..utils.process import is_primary

    if not is_primary():
        # multi-process runs: process 0 owns the output directory (creation,
        # clobber protection, manifest); other processes only need the path
        return dirname
    os.makedirs(data_dir, exist_ok=True)
    if os.path.exists(dirname) and reuse_existing:
        # in-place resume: keep every artifact (checkpoints included),
        # refresh the manifest below
        pass
    elif os.path.exists(dirname):
        if overwrite:
            for entry in os.listdir(dirname):
                path = os.path.join(dirname, entry)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        else:
            raise ValueError(f"{dirname} already exists! Use a different name")
    else:
        os.makedirs(dirname)
    args_name = os.path.join(dirname, "args.json")
    payload = cfg.to_json_dict() if hasattr(cfg, "to_json_dict") else dict(vars(cfg))
    if reuse_existing and os.path.exists(args_name):
        # surface silently-changed flags on an in-place resume — the
        # manifest records what produced the surviving artifacts
        try:
            with open(args_name) as f:
                prev = json.load(f)
            # per-invocation keys always differ across a retry (a resume
            # strips -ow and sets --resume) — comparing them would make
            # the warning fire on EVERY legitimate retry and bury the
            # real signal (a silently changed lr/num_batches)
            invocation_keys = {"resume", "overwrite"}
            changed = sorted(k for k in payload
                             if k not in invocation_keys
                             and k in prev and prev[k] != payload[k])
            if changed:
                print(f"[outdir] resume overrides recorded flags: "
                      f"{', '.join(changed)}", file=sys.stderr, flush=True)
        except (OSError, ValueError):
            pass
    # atomic: a preemption mid-write must not leave corrupt JSON (sample.py
    # rebuilds the model from this manifest)
    tmp = args_name + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, args_name)
    return dirname
