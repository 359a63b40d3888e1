"""``planes.stages``: plane stages and restages (``delta_stages`` +
``full_restages`` of ``DeviceStatsCache``) inside the window, 0 in a
steady state; ``planes.resident_mb``: ``cache.resident_bytes`` after it."""

from __future__ import annotations


def read(run, name: str):
    if name == "planes.stages":
        d = run.delta("staging")
        return float(d["delta_stages"] + d["full_restages"])
    if name == "planes.resident_mb":
        return run.resident_bytes / 1e6
    return None
