"""``stage_ms.<technique>``: host-clock ms a batch in ``core/flow.py``'s
``<Technique>.run_batch`` (the ``stage.<technique>`` spans), for the
techniques some query of the window uses."""

from __future__ import annotations

from . import window_batches


def read(run, name: str):
    tech = name.split(".", 1)[1]
    if run.trace is None or not any(
            tech in run.stream.spec(i).stages for i in run.window):
        return None
    spans = run.trace.spans_of(f"stage.{tech}")
    batches = window_batches(run)
    if not spans or not batches:
        return None
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / batches
