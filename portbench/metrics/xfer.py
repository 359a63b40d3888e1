"""``xfer.h2d_mb`` / ``xfer.d2h_mb``: MB a batch copied host to card and
back, from the profiler's memcpy records inside the window."""

from __future__ import annotations

from . import window_batches


def read(run, name: str):
    tr = run.trace
    batches = window_batches(run)
    if tr is None or not batches:
        return None
    tag = {"xfer.h2d_mb": "HtoD", "xfer.d2h_mb": "DtoH"}[name]
    nbytes = sum(o.nbytes for o in tr.ops if o.cat == "gpu_memcpy"
                 and tag in o.name and tr.t_open <= o.t0 <= tr.t_close)
    return nbytes / 1e6 / batches
