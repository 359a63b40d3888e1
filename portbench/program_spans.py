"""The program's own spans (``repro_torch.tracing``) inside a traced run's
window, for the readers of ``metrics/host_ms.py``, ``launch_ms.py``,
``admission.py`` and ``topk_scan.py``.

The program records its spans on ``time.perf_counter`` while the
profiler records, which is the window of a ``--trace 1`` run; the
benchmark's own spans (``trace.py``) use the same clock.  A span belongs
to the window when it starts inside ``t_open``–``t_close``.  Without a
trace, without the tracer (a program that has none), or when the ring
dropped spans of the window, there is nothing to read: None.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def window_spans(run) -> Optional[list]:
    tr = run.trace
    if tr is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if tracing.dropped() and tracing.dropped_through() >= tr.t_open:
        return None
    return [s for s in tracing.records() if tr.t_open <= s.t0 <= tr.t_close]


def self_ms(spans: list, name: str) -> Optional[float]:
    """Total self time (ms) of the spans named ``name``: each one's
    duration less what its child program spans cover; None when there is
    none."""
    from repro_torch import tracing

    own = tracing.self_seconds(spans)
    picked = [s for s in spans if s.name == name]
    if not picked:
        return None
    return 1e3 * sum(own[s.sid] for s in picked)


def children(spans: list) -> Dict[int, List[object]]:
    """The child spans of each span id."""
    out: Dict[int, List[object]] = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out
