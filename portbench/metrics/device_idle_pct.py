"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or memset ran on the card."""

from __future__ import annotations


def read(run, name: str):
    tr = run.trace
    if tr is None or tr.t_close <= tr.t_open:
        return None
    busy = sum(b - a for a, b in tr.busy_intervals())
    return 100.0 * (1.0 - busy / (tr.t_close - tr.t_open))
