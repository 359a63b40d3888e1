"""The mixes the cells run read as before the mix language took ``joins``
and ``in``: the first 2,000 queries of each on three seeds, and the
reference's answers to the first 256 on the tiny tables, hashed and
compared with the digests taken before those additions."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

from portbench import gen
from portbench.reference.engine import Reference
from portbench.traffic import Stream

from .tiny import SEED, tiny_cell

# (cell, seed) -> (digest of the query specs, digest of the answers)
FROZEN = {
    ("events-prod.mixed", SEED): (
        "ff348bb2487bb4561e35b3a1ccdf29e8c5b133805a6e6bb0a37a30f557a93a60",
        "ff75d1ca5594e4a14f5dc335a7a624ddaa75a71dc64546461db15e093b407101"),
    ("events-prod.mixed", SEED + 1): (
        "fc484da5baebdcad65ed6de0c798362100931a720218c8c38f154891809d680f",
        "384ee099db8a9a7070e16df0e0edd6a7ddeaf3dcc460d10badf45dbc9b898eac"),
    ("events-prod.mixed", 7): (
        "eac558c406c5fcd7c032653b463490c6a07efebdfb5c3ca4977c6c536fb52c51",
        "7eea357ac97201482973fdc2d3b8aff0183fa9886a06df2a5a6a20216e38c2ec"),
    ("tpch-sf1000.mixed", SEED): (
        "1539736e3b051181c46bfb482bb0a57da0bfc6cd99fa0a1bf983dbd762d7e4a0",
        "783ea998f77c8b0fa61db7abbaa1237e6d686a6ddb370b95c84f12e19d61d450"),
    ("tpch-sf1000.mixed", SEED + 1): (
        "124f0cbb6bcc90309b3e73921f730d8b284d6243eb335eac35d60f47785bfd0f",
        "b7354f6c06a6a5c03d3cfc1d5a7710b25c87216edc74350189c2869bce34ae3b"),
    ("tpch-sf1000.mixed", 7): (
        "08365a175f2b0faabde78112c5c652114f9e776846fbba5d9c97271bb2b3b21d",
        "faef041486e113ecfa21c243793d31b14bb3b403513892712f15c25aedc919db"),
}


def _feed(h, obj) -> None:
    """Hash ``obj`` by value: arrays with their dtype, dicts by sorted
    key, NumPy scalars as Python numbers."""
    if isinstance(obj, np.ndarray):
        h.update(str(obj.dtype).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, dict):
        h.update(b"{")
        for k in sorted(obj):
            h.update(repr(k).encode())
            _feed(h, obj[k])
        h.update(b"}")
    elif isinstance(obj, (list, tuple)):
        h.update(b"(")
        for x in obj:
            _feed(h, x)
        h.update(b")")
    elif isinstance(obj, np.generic):
        h.update(repr(obj.item()).encode())
    else:
        h.update(repr(obj).encode())


@pytest.mark.parametrize("name,seed", sorted(FROZEN, key=str))
def test_streams_and_answers_are_unchanged(name, seed):
    cell = tiny_cell(name)
    stream = Stream(cell.mix, seed)
    specs = [stream.spec(i) for i in range(2000)]
    assert not any(q.joins for q in specs)
    hs, ha = hashlib.sha256(), hashlib.sha256()
    for q in specs:
        _feed(hs, (q.index, q.kind, q.scans, q.join, q.limit, q.offset,
                   q.order_by))
    ref = Reference(gen.make_tables(cell.config, seed), cell.config)
    for q in specs[:256]:
        _feed(ha, ref.answer(q))
    assert (hs.hexdigest(), ha.hexdigest()) == FROZEN[name, seed]
