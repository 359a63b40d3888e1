"""``filter_roofline``: the filter stage's need (``need.filter_bytes``)
over the card's memory rate, as a share of the device time of every kernel
launched inside the ``stage.filter`` spans.  Predicates seen in the
warm-up count as seen."""

from __future__ import annotations

from ..need import filter_bytes
from ..traffic import Stream
from . import roofline, specs


def read(run, name: str):
    warm = Stream(run.cell.mix, run.seed, salt=1)
    seen: set = set()
    filter_bytes(run.ref, [warm.spec(i) for i in run.warmup], seen)
    return roofline(run, "stage.filter",
                    lambda s: filter_bytes(run.ref, specs(run, s.payload),
                                           seen))
