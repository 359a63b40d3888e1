"""``host_ms.<technique>.<part>``: ms a batch of host time in one part of a
stage, the self time of the program's ``<technique>.<part>`` spans in the
window (``topk.order`` and ``topk.scan`` in ``core/prune_topk.run_topk``;
``join.build``, ``join.summary`` and ``join.match`` around
``JoinTechnique``'s calls of ``_build_keys``, ``summarize_build`` and
``prune_probe``; ``filter.plan`` and ``filter.decode`` in
``PruningService.prune_batch``)."""

from __future__ import annotations

from ..program_spans import self_ms, window_spans
from . import window_batches


def read(run, name: str):
    spans = window_spans(run)
    batches = window_batches(run)
    if spans is None or not batches:
        return None
    ms = self_ms(spans, name.split(".", 1)[1])
    return None if ms is None else ms / batches
