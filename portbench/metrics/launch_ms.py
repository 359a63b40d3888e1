"""``launch_ms.<kernel>.host`` / ``.wait``: ms a batch in a batched
launch wrapper of ``kernels/ops.py``.  ``wait`` is its
``launch.readback`` child, where the host waits on the card for the
output; ``host`` is the rest of the ``launch.<kernel>`` span (packing,
the H2D enqueue, the launch)."""

from __future__ import annotations

from ..program_spans import children, window_spans
from . import window_batches


def read(run, name: str):
    spans = window_spans(run)
    batches = window_batches(run)
    if spans is None or not batches:
        return None
    _family, kernel, part = name.split(".")
    launches = [s for s in spans if s.name == f"launch.{kernel}"]
    if not launches:
        return None
    kids = children(spans)
    total = wait = 0.0
    for s in launches:
        total += s.t1 - s.t0
        wait += sum(c.t1 - c.t0 for c in kids.get(s.sid, ())
                    if c.name == "launch.readback")
    return 1e3 * (wait if part == "wait" else total - wait) / batches
