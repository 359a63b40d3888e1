"""Per-layer metric readers, one module a family, found by name.

The metric ``<family>.<part>`` (or ``<family>`` alone) is read by
``metrics/<family>.py``'s ``read(run, name)``, which returns a number or
None when the run holds nothing to read (the harness then leaves the
metric out of the line).  ``run`` is ``harness.Run``; a traced run's
``run.trace`` is ``trace.Trace``.
"""

from __future__ import annotations

from typing import Callable, List, Optional


def window_batches(run) -> int:
    return int(run.delta("latency")["batches"])


def roofline(run, label: str, bytes_of: Callable[[object], int]
             ) -> Optional[float]:
    """100 x (the need of every ``label`` span in the window over the
    card's memory rate) / (the device time of the kernels started inside
    those spans); None without a trace or without kernel time."""
    from ..need import HBM_BYTES_PER_S

    tr = run.trace
    if tr is None:
        return None
    spans = sorted(tr.spans_of(label), key=lambda s: s.t0)
    need = kernel = 0.0
    for span, dev_s in tr.kernels_in(spans):
        if dev_s <= 0.0:
            continue
        need += bytes_of(span) / HBM_BYTES_PER_S
        kernel += dev_s
    return 100.0 * need / kernel if kernel > 0.0 else None


def specs(run, indices) -> List[object]:
    return [run.stream.spec(i) for i in indices if i >= 0]
