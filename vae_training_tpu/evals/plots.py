"""matplotlib access for the diagnostic plots.

matplotlib is an optional dependency: without it every plot event is
skipped (announced once per process on stderr) and training continues —
``losses.npz`` carries every number the plots show.
"""

from __future__ import annotations

import functools
import sys


@functools.cache
def _report_missing() -> None:
    print("[plot] matplotlib is not installed; skipping diagnostic plots "
          "(losses.npz still records every stat)", file=sys.stderr, flush=True)


def pyplot():
    """``matplotlib.pyplot`` on the non-interactive Agg backend, or None
    when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError:
        _report_missing()
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
