"""The port's spans (``utils/profiling.py``): off by default, where a span
is one shared no-op that reads no clock; on, the names, parents and call
ids of a query and of a sort; and, on a card, the spans on the clock of
the profiler's device rows (the test marked ``cuda``)."""

import json
import time

import numpy as np
import pytest
import torch

import radix_sort_tpu_torch as rtt
from radix_sort_tpu_torch.utils import profiling


@pytest.fixture
def spans_off():
    """Spans off and none kept, before and after the test."""
    profiling.disable()
    profiling.take_spans()
    yield
    profiling.disable()
    profiling.take_spans()


@pytest.fixture
def clock_reads(monkeypatch):
    """The recorder's clock, counting its reads."""
    reads = [0]
    real = profiling._now

    def now():
        reads[0] += 1
        return real()

    monkeypatch.setattr(profiling, "_now", now)
    return reads


def _q1_table(n=3000, seed=5):
    g = torch.Generator().manual_seed(seed)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (n,), generator=g, dtype=dtype)

    return rtt.Table({
        "l_quantity": ints(100, 5100, torch.int64),
        "l_extendedprice": ints(90000, 10500000, torch.int64),
        "l_discount": ints(0, 11, torch.int64),
        "l_tax": ints(0, 9, torch.int64),
        "l_returnflag": ints(0, 3, torch.uint8),
        "l_linestatus": ints(0, 2, torch.uint8),
        "l_shipdate": ints(8000, 10600, torch.int32)})


def _q1(table):
    """TPC-H Q1's shape: a filter, three derived columns, a group-by with
    sums, means and a count, a sort of the groups, the result to the
    host."""
    q = (rtt.Query(table)
         .filter("l_shipdate", "le", 10471)
         .with_column("disc_price",
                      lambda t: t["l_extendedprice"] * (100 - t["l_discount"]))
         .with_column("charge", lambda t: t["disc_price"] * (100 + t["l_tax"]))
         .with_column("grp", lambda t: t["l_returnflag"].to(torch.int16) * 256
                      + t["l_linestatus"].to(torch.int16))
         .group_by("grp", sum_qty=("sum", "l_quantity"),
                   sum_charge=("sum", "charge"),
                   avg_disc=("mean", "l_discount"), n=("count", None))
         .sort_by("grp"))
    return q.collect().to_numpy()


def _sort_kv_i64():
    g = torch.Generator().manual_seed(7)
    keys = torch.randint(0, 2**31 - 1, (2000,), generator=g,
                         dtype=torch.int32)
    vals = torch.randint(-2**62, 2**62, (2000,), generator=g,
                         dtype=torch.int64)
    return rtt.sort_kv(keys, vals)


def test_spans_off_record_nothing_and_read_no_clock(spans_off, clock_reads):
    off = profiling.span("query", rows=1)
    assert off is profiling.span("sort_kv") and not isinstance(
        off, profiling._Open)
    with off:
        pass
    _q1(_q1_table())
    _sort_kv_i64()
    rtt.argsort(torch.arange(100, 0, -1, dtype=torch.int32))
    assert clock_reads[0] == 0
    assert profiling.take_spans() == []


def _by_id(spans):
    return {s.id: s for s in spans}


def _check_nesting(spans):
    """Each parent is recorded, opened before its child and closed after
    it, and shares its call id; an outermost span's call id is its own."""
    by = _by_id(spans)
    roots = [s for s in spans if s.parent is None]
    assert len({s.call for s in roots}) == len(roots)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = by[s.parent]
        assert p.id < s.id and p.call == s.call
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def _ancestors(s, by):
    out = []
    while s.parent is not None:
        s = by[s.parent]
        out.append(s.name)
    return out


def test_query_spans_name_each_step(spans_off, clock_reads):
    table = _q1_table()
    profiling.enable()
    got = _q1(table)
    profiling.disable()
    spans = profiling.take_spans()
    assert clock_reads[0] == 2 * len(spans) > 0
    _check_nesting(spans)
    by = _by_id(spans)
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["query", "to_host"]
    query, to_host = roots
    assert query.attrs == {"rows": 3000, "steps": 6}
    steps = [s.name for s in spans if s.parent == query.id]
    assert steps == ["query.filter"] + ["query.with_column"] * 3 + [
        "query.group_by", "query.sort_by"]
    assert [s.name for s in spans if s.parent == to_host.id] == [
        "to_host.wait"]
    assert {s.call for s in spans} == {query.call, to_host.call}
    # every sort and word-plane copy lies in the step that made it
    inner = [s for s in spans
             if s.name in ("radix.sort_passes", "planes.split",
                           "planes.join")]
    assert {s.name for s in inner} == {"radix.sort_passes", "planes.split",
                                       "planes.join"}
    for s in inner:
        step = [a for a in _ancestors(s, by) if a.startswith("query.")]
        assert step and step[0] in ("query.filter", "query.group_by",
                                    "query.sort_by"), (s, step)
    names = {s.name for s in spans}
    assert names == {"query", "query.filter", "query.with_column",
                     "query.group_by", "query.sort_by", "query.cut",
                     "radix.sort_passes", "planes.split", "planes.join",
                     "to_host", "to_host.wait"}
    # the filter's and the group-by's tables are cut to their valid rows
    # inside the step that follows each
    kept = int((table["l_shipdate"] <= 10471).sum())
    cuts = [(by[s.parent].name, s.attrs) for s in spans
            if s.name == "query.cut"]
    assert cuts == [("query.group_by", {"rows": 3000, "kept": kept}),
                    ("query.sort_by", {"rows": kept, "kept": 6})]
    # the spans change nothing of the answer
    np.testing.assert_array_equal(got["sum_qty"], _q1(table)["sum_qty"])


def test_query_sorts_count_their_8_byte_planes(spans_off):
    """Each sort and compaction of the Q1 shape names in its
    radix.sort_passes span the 8-byte planes it moves as they are: the
    filter's four int64 decimals beside the int32 date and the two widened
    flags, the group-by sort's three int64 inputs, its compaction's three
    int64 sums beside the int32 key and counts, the final sort's 8-byte
    result columns."""
    profiling.enable()
    _q1(_q1_table())
    profiling.disable()
    spans = profiling.take_spans()
    by = _by_id(spans)
    got = [([a for a in _ancestors(s, by) if a.startswith("query.")][0],
            s.attrs) for s in spans if s.name == "radix.sort_passes"]
    assert got == [("query.filter", {"planes": 7, "wide": 4}),
                   ("query.group_by", {"planes": 3, "wide": 3}),
                   ("query.group_by", {"planes": 6, "wide": 3}),
                   ("query.sort_by", {"planes": 5, "wide": 3})]


def test_sort_spans_and_attributes(spans_off):
    profiling.enable()
    _sort_kv_i64()
    rtt.argsort(torch.arange(100, 0, -1, dtype=torch.int32))
    profiling.disable()
    spans = profiling.take_spans()
    _check_nesting(spans)
    by = _by_id(spans)
    got = [(s.name, by[s.parent].name if s.parent is not None else None)
           for s in spans]
    # the int64 payload rides as one 8-byte plane: no split or join of
    # its words inside the payloads' spans
    kv = [("sort_kv", None),
          ("planes.split", "sort_kv"),       # the payloads into planes
          ("planes.split", "sort_kv"),       # the key's word plane
          ("radix.sort_passes", "sort_kv"),
          ("planes.join", "sort_kv"),        # the key back
          ("planes.join", "sort_kv")]        # the payloads back
    arg = [("argsort", None), ("sort_kv", "argsort"),
           ("planes.split", "sort_kv"), ("planes.split", "sort_kv"),
           ("radix.sort_passes", "sort_kv"), ("planes.join", "sort_kv"),
           ("planes.join", "sort_kv")]
    assert got == kv + arg
    assert spans[0].attrs == {"rows": 2000}
    assert spans[1].attrs == {"bytes": 2000 * 8}
    assert spans[3].attrs == {"planes": 1, "wide": 1}
    assert spans[len(kv) + 4].attrs == {"planes": 1, "wide": 0}
    assert spans[0].call != spans[len(kv)].call


def test_a_span_that_raises_still_closes(spans_off):
    profiling.enable()
    with pytest.raises(rtt.EngineError):
        rtt.sort_kv(torch.arange(10, dtype=torch.int32),
                    torch.arange(9, dtype=torch.int32))
    with pytest.raises(RuntimeError):
        with profiling.span("outer"):
            with profiling.span("inner", rows=3):
                raise RuntimeError("in the span")
    with profiling.span("after"):
        pass
    profiling.disable()
    spans = profiling.take_spans()
    assert [(s.name, s.parent) for s in spans] == [
        ("sort_kv", None), ("outer", None), ("inner", spans[1].id),
        ("after", None)]
    _check_nesting(spans)
    assert len({s.call for s in spans}) == 3
    assert profiling.take_spans() == []


def _join_query():
    """A probe of 300 rows (250 valid after the filter) joined with a build
    of 40 keys: the int64 key of Q3's joins."""
    g = torch.Generator().manual_seed(3)
    probe = rtt.Table({"k": torch.randint(0, 60, (300,), generator=g),
                       "v": torch.arange(300, dtype=torch.int32)})
    build = rtt.Table({"k": torch.arange(0, 80, 2),
                       "w": torch.arange(40, dtype=torch.int64) * 7})
    q = rtt.Query(probe).filter("v", "lt", 250).join(build, on="k")
    return q.collect().to_numpy(), q.last_stats["join"]


@pytest.mark.parametrize("on", [True, False])
def test_join_spans_and_sorted_rows(spans_off, on):
    """On, the query's join step holds query.cut (the filtered probe cut
    to its 250 valid rows beside the 40 of the build), then join.sort,
    join.match and join.compact, each with rows = the cut probe + build
    rows (join.sort with the bytes of its int64 key and int32 row id), and
    join.gather with rows = the output capacity, the cut probe's 250;
    off, nothing is recorded.  Either way ``join.sorted_rows`` grows by
    that count and ``join.sorted_bytes`` by 12 bytes a row."""
    from radix_sort_tpu_torch.ops import join as join_ops

    before = join_ops.sorted_rows, join_ops.sorted_bytes
    if on:
        profiling.enable()
    got, stats = _join_query()
    profiling.disable()
    spans = profiling.take_spans()
    assert join_ops.sorted_rows - before[0] == 250 + 40
    assert join_ops.sorted_bytes - before[1] == 12 * (250 + 40)
    assert int(stats["match_count"]) == len(got["k"]) > 0
    assert not bool(stats["overflow"])
    if not on:
        assert spans == []
        return
    _check_nesting(spans)
    by = _by_id(spans)
    (step,) = [s for s in spans if s.name == "query.join"]
    inner = [s for s in spans if s.parent == step.id]
    assert [s.name for s in inner] == ["query.cut", "join.sort",
                                       "join.match", "join.compact",
                                       "join.gather"]
    assert [s.attrs for s in inner] == [
        {"rows": 300 + 40, "kept": 250 + 40}, {"rows": 290, "bytes": 12 * 290},
        {"rows": 290}, {"rows": 290}, {"rows": 250}]
    for s in spans:
        if s.name == "radix.sort_passes":
            assert {"join.sort", "join.compact",
                    "query.filter"} & set(_ancestors(s, by))
    again, _ = _join_query()  # the spans change nothing of the answer
    for k, v in got.items():
        np.testing.assert_array_equal(v, again[k])


@pytest.mark.cuda
def test_spans_share_the_device_trace_clock(spans_off, tmp_path):
    """A kernel, then a span of 2 ms of host work that ends by launching
    a second kernel: in the trace that ``profiling.trace`` writes, the
    device's idle gap between the two kernels starts and ends within 50
    us of the span, and the host records of the two launches lie before
    and inside it.  A first kernel and a synchronise come before, so that
    the profiler's own set-up (its first launch asks for its buffers, ~2
    ms on an H100) lies outside the gap; the host spins rather than
    sleeps, so that it is awake at the span's end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x = torch.zeros(1024, device="cuda")
    x.add_(1)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path)):
        x.add_(1)
        torch.cuda.synchronize()
        x.add_(1)
        with profiling.span("host.work"):
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.002:
                pass
            x.add_(1)
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    rows = json.loads(path.read_text())["traceEvents"]

    def named(cat, name=""):
        return sorted((r for r in rows if r.get("cat") == cat
                       and r["name"].startswith(name)),
                      key=lambda r: r["ts"])

    kernels = named("kernel")
    launches = named("cuda_runtime", "cudaLaunchKernel")
    (sp,) = named("span")
    assert sp["name"] == "host.work" and len(kernels) == 3, kernels
    assert len(launches) == 3, launches
    end = sp["ts"] + sp["dur"]
    assert launches[1]["ts"] <= sp["ts"] <= launches[2]["ts"] <= end
    gap0 = kernels[1]["ts"] + kernels[1]["dur"]
    gap1 = kernels[2]["ts"]
    assert abs(gap0 - sp["ts"]) <= 50, (gap0, sp)
    assert abs(gap1 - end) <= 50, (gap1, sp)
