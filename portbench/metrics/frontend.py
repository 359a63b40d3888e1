"""``frontend.query_p95_ms``: the 95th percentile of submit -> answer over
every query of the window; ``frontend.batch_queries``: queries a fired
batch, from the front-end's ``requests`` and ``*_fired`` counters."""

from __future__ import annotations

import numpy as np


def read(run, name: str):
    if name == "frontend.query_p95_ms":
        if not run.latencies_ms:
            return None
        return float(np.percentile(np.asarray(run.latencies_ms), 95.0))
    if name == "frontend.batch_queries":
        d = run.delta("latency")
        fired = d["size_fired"] + d["deadline_fired"] + d["flush_fired"]
        return d["requests"] / fired if fired else None
    return None
