"""``admission.wait_p95_ms``: the 95th percentile of the time a query
waits in the front-end, from ``submit`` until its batch enters
``run_batch`` (the program's ``frontend.queue`` spans in the window)."""

from __future__ import annotations

import numpy as np

from ..program_spans import window_spans


def read(run, name: str):
    spans = window_spans(run)
    if spans is None:
        return None
    waits = [s.t1 - s.t0 for s in spans if s.name == "frontend.queue"]
    if not waits:
        return None
    return 1e3 * float(np.percentile(np.asarray(waits), 95.0))
