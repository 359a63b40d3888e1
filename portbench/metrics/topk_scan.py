"""``topk_scan.useful_pct``: of the partitions the host top-k scan read,
the share whose rows entered the heap (the ``improved`` and ``read``
counts of the program's ``topk.scan`` spans in the window)."""

from __future__ import annotations

from ..program_spans import window_spans


def read(run, name: str):
    spans = window_spans(run)
    if spans is None:
        return None
    scans = [s.attrs for s in spans if s.name == "topk.scan"]
    read_ = sum(a.get("read", 0) for a in scans)
    if not read_:
        return None
    return 100.0 * sum(a.get("improved", 0) for a in scans) / read_
