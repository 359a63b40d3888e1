"""``topk_init_roofline``: the top-k boundary init's need
(``need.topk_init_bytes``) as a share of the device time of the kernels
inside the ``stage.topk.init`` spans; each init's queries are found
through the enclosing ``stage.topk`` span."""

from __future__ import annotations

from ..need import topk_init_bytes
from . import roofline, specs


def read(run, name: str):
    tr = run.trace
    if tr is None:
        return None
    outer = tr.spans_of("stage.topk")

    def indices(span):
        for o in outer:
            if o.thread == span.thread and o.t0 <= span.t0 <= o.t1:
                return [o.payload.get(sid, -1) for sid in span.payload]
        return []

    return roofline(run, "stage.topk.init",
                    lambda s: topk_init_bytes(run.ref,
                                              specs(run, indices(s))))
