"""The port's Iceberg two-level pruning (Sec. 8.1) and pruned data
pipeline against the JAX package's.

``IcebergTable.from_table`` and ``two_level_prune`` replace the
reference's per-file loops by segmented reductions and one gather; on
the same table (hypothesis draws over ``tests/helpers.py``'s
``small_tables`` / ``predicates``, carried into the port) the manifest
stats, the group verdicts and the metadata-read counts must be
identical, with ``G`` not a multiple of ``groups_per_file`` and with
files missing their metadata among the cases.  The curation, the work
queue and the loader's token batches must be the same numbers too.
"""

import types

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import expr as RE
from repro.core.prune_filter import eval_tv as r_eval_tv
from repro.data import iceberg as RI
from repro.data import pipeline as RP
from repro.data.table import Table as RTable

from repro_torch.core import expr as TE
from repro_torch.core.prune_filter import eval_tv as t_eval_tv
from repro_torch.data import iceberg as TI
from repro_torch.data import pipeline as TP

from helpers import predicates, small_tables
from test_torch_host import assert_stats_equal, port_pred, port_table

torch.set_num_threads(1)


def assert_ice_equal(got, want):
    np.testing.assert_array_equal(got.file_of_group, want.file_of_group)
    np.testing.assert_array_equal(got.has_metadata, want.has_metadata)
    assert_stats_equal(got.file_stats, want.file_stats)


def assert_two_level_equal(got, want):
    assert got.group_tv.dtype == want.group_tv.dtype
    np.testing.assert_array_equal(got.group_tv, want.group_tv)
    assert (got.files_pruned, got.file_meta_reads, got.group_meta_reads) \
        == (want.files_pruned, want.file_meta_reads, want.group_meta_reads)


@settings(max_examples=60, deadline=None)
@given(tbl=small_tables(), pred=predicates(),
       gpf=st.sampled_from([1, 2, 3, 5, 8]),
       missing=st.lists(st.integers(0, 40), min_size=0, max_size=3))
def test_two_level_equals_reference(tbl, pred, gpf, missing):
    tt, tp = port_table(tbl), port_pred(pred)
    F = -(-tbl.num_partitions // gpf)
    miss = np.array(sorted({m % F for m in missing}), dtype=np.int64)
    want_ice = RI.IcebergTable.from_table(tbl, gpf, miss if len(miss)
                                          else None)
    got_ice = TI.IcebergTable.from_table(tt, gpf, miss if len(miss)
                                         else None)
    assert_ice_equal(got_ice, want_ice)
    got, want = TI.two_level_prune(tp, got_ice), RI.two_level_prune(
        pred, want_ice)
    assert_two_level_equal(got, want)
    np.testing.assert_array_equal(got.group_tv, t_eval_tv(tp, tt.stats))
    for f in miss:
        assert got_ice.backfill(int(f)) == want_ice.backfill(int(f))
    assert_two_level_equal(TI.two_level_prune(tp, got_ice),
                           RI.two_level_prune(pred, want_ice))


def clustered(n=4000, rows_pp=100, seed=0):
    rng = np.random.default_rng(seed)
    rt = RTable.build(
        "t", {"v": rng.permutation(np.arange(n)).astype(np.int64),
              "w": np.sort(rng.integers(0, 10_000, size=n)).astype(np.int64)},
        rows_per_partition=rows_pp)
    return rt, port_table(rt)


@pytest.mark.parametrize("n,rows_pp,gpf", [(4000, 100, 8), (4100, 100, 8),
                                           (3990, 70, 3), (50, 100, 8)])
def test_metadata_io_saved_on_clustered_data(n, rows_pp, gpf):
    """G = 40, 41 (one group past a whole file), 57, 1."""
    rt, tt = clustered(n, rows_pp)
    want_ice = RI.IcebergTable.from_table(rt, groups_per_file=gpf)
    got_ice = TI.IcebergTable.from_table(tt, groups_per_file=gpf)
    assert_ice_equal(got_ice, want_ice)
    for lo in (0, 5_000, 9_000, 9_999):
        got = TI.two_level_prune(TE.col("w") >= lo, got_ice)
        assert_two_level_equal(got, RI.two_level_prune(RE.col("w") >= lo,
                                                       want_ice))
    got = TI.two_level_prune(TE.col("w") >= 9_000, got_ice)
    if n >= 4000:
        assert got.files_pruned > 0
        assert got.group_meta_reads < tt.num_partitions / 2


@pytest.mark.parametrize("missing", [[0, 1], [4], [0, 2, 4]])
def test_missing_metadata_blocks_pruning_until_backfill(missing):
    rt, tt = clustered(4100)
    miss = np.array(missing)
    ice = {p: m.IcebergTable.from_table(t, groups_per_file=8,
                                        missing_meta_files=miss)
           for p, m, t in (("t", TI, tt), ("r", RI, rt))}
    assert_ice_equal(ice["t"], ice["r"])
    preds = {"t": TE.col("w") >= 9_999_999, "r": RE.col("w") >= 9_999_999}
    mods = {"t": TI, "r": RI}
    res = {p: mods[p].two_level_prune(preds[p], ice[p]) for p in ice}
    assert_two_level_equal(res["t"], res["r"])
    sel = np.isin(ice["t"].file_of_group, miss)
    assert res["t"].group_meta_reads >= sel.sum()
    cost = {p: sum(ice[p].backfill(int(f)) for f in miss) for p in ice}
    assert cost["t"] == cost["r"] > 0
    res2 = {p: mods[p].two_level_prune(preds[p], ice[p]) for p in ice}
    assert_two_level_equal(res2["t"], res2["r"])
    assert res2["t"].group_meta_reads < res["t"].group_meta_reads
    np.testing.assert_array_equal(res2["t"].group_tv,
                                  r_eval_tv(preds["r"], rt.stats))


# ---------------------------------------------------------------------------
# the pruned data pipeline
# ---------------------------------------------------------------------------

REF = types.SimpleNamespace(E=RE, P=RP)
PORT = types.SimpleNamespace(E=TE, P=TP)


@pytest.mark.parametrize("seed,n_shards,docs,q", [
    (0, 128, 8, 0.5), (1, 64, 8, 0.3), (2, 300, 16, 0.8)])
def test_curation_equals_reference(seed, n_shards, docs, q):
    out = []
    for pk in (PORT, REF):
        meta = pk.P.make_corpus_metadata(np.random.default_rng(seed),
                                         n_shards=n_shards,
                                         docs_per_shard=docs)
        pred = ((pk.E.col("quality") >= q)
                | pk.E.startswith(pk.E.col("lang"), "en"))
        scan, rep = pk.P.curate(meta, pred)
        out.append((scan.part_ids.tolist(), scan.match.tolist(),
                    rep.shards_total, rep.shards_selected, rep.pruning_ratio,
                    meta.stats.mins.tobytes(), meta.stats.maxs.tobytes()))
    assert out[0] == out[1]


def _drive(q, order):
    seen = []
    for w in order:
        sid = q.next_for(w)
        seen.append(sid)
    return seen


@pytest.mark.parametrize("n,workers,order", [
    (37, 4, [0, 1, 2, 3] + [0, 1, 2] * 20),
    (40, 2, [0] * 35),
    (10, 3, [2, 2, 2, 2, 0, 1, 0, 1, 2, 2, 2, 0, 0, 0]),
])
def test_work_queue_equals_reference(n, workers, order):
    got = TP.WorkQueue(np.arange(n), n_workers=workers)
    want = RP.WorkQueue(np.arange(n), n_workers=workers)
    assert _drive(got, order) == _drive(want, order)
    assert got.state() == want.state()
    seen = [s for s in _drive(TP.WorkQueue(np.arange(n), workers), order)
            if s is not None]
    assert len(seen) == len(set(seen))


def test_work_queue_state_roundtrip():
    q = TP.WorkQueue(np.arange(10), n_workers=2)
    for _ in range(3):
        q.next_for(0)
    q2 = TP.WorkQueue(np.arange(10), n_workers=2)
    q2.restore(q.state())
    assert q2.next_for(0) == q.next_for(0)
    assert q2.state() == q.state()


@pytest.mark.parametrize("sid,tps,vocab,seed", [(0, 64, 1000, 0),
                                                (17, 4096, 50_000, 7),
                                                (2 ** 20 - 1, 10, 3, 1)])
def test_shard_tokens_equal_reference(sid, tps, vocab, seed):
    got = TP.shard_tokens(sid, tps, vocab, seed)
    want = RP.shard_tokens(sid, tps, vocab, seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _loader(pk, meta_seed, **kw):
    meta = pk.P.make_corpus_metadata(np.random.default_rng(meta_seed),
                                     n_shards=64, docs_per_shard=8)
    scan, _ = pk.P.curate(meta, pk.E.col("quality") >= 0.3)
    return pk.P.PrunedDataLoader(scan, **kw)


@pytest.mark.parametrize("seq,tps", [(32, 32_768), (64, 100), (300, 128)])
def test_loader_batches_equal_reference(seq, tps):
    kw = dict(worker=0, n_workers=2, batch_size=2, seq_len=seq, vocab=500,
              tokens_per_shard=tps, seed=7)
    got = list(_loader(PORT, 1, **kw))
    want = list(_loader(REF, 1, **kw))
    assert len(got) == len(want) > 2
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert isinstance(g[k], torch.Tensor)
            assert g[k].dtype == torch.int32 and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


@pytest.mark.parametrize("seq,tps,cut", [(32, 32_768, 5), (64, 100, 3),
                                         (300, 128, 4)])
def test_loader_resumes_from_state(seq, tps, cut):
    """A loader restored from ``state()`` mid-stream yields the same
    batches as the one that kept going (and as the reference)."""
    kw = dict(worker=1, n_workers=2, batch_size=3, seq_len=seq, vocab=900,
              tokens_per_shard=tps, seed=3)
    a = _loader(PORT, 2, **kw)
    it = iter(a)
    for _ in range(cut):
        next(it)
    st_ = a.state()
    rest = [b["tokens"].numpy() for b in it]
    b = _loader(PORT, 2, **kw)
    b.restore(st_)
    resumed = [x["tokens"].numpy() for x in b]
    assert len(resumed) == len(rest) > 0
    for x, y in zip(resumed, rest):
        np.testing.assert_array_equal(x, y)
    want = [w["tokens"] for w in _loader(REF, 2, **kw)][cut:]
    for x, y in zip(resumed, want):
        np.testing.assert_array_equal(x, y)
    assert b.state() == a.state()
