"""``ladder.demotions``: rungs demoted in the window, summed over the
``DegradationLadder``'s per-rung counters (``counters["resilience"]``)."""

from __future__ import annotations


def read(run, name: str):
    if name != "ladder.demotions":
        return None
    return float(sum(run.delta("demotions").values()))
