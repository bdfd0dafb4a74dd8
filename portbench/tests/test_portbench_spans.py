"""The stretch with the program's spans on (``portbench/spans.py``) and the
readers of the program's spans: on synthetic stretches with known launch
times, spans and gaps, each reader's value; None where the program
recorded no span; the other readers and the result line as they were;
and a traced run on the CPU that takes the stretch from the program."""

import json
import time

import pytest

from portbench import core, result, spans, spec, trace

KV = "void (anonymous namespace)::rank_scatter_kernel<256, 32, true, " \
     "unsigned int, 4>((anonymous namespace)::DigitPlanes, long)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, " \
       "at::native::CUDAFunctor_add<long>>(int)"
ARANGE = "void (anonymous namespace)::elementwise_kernel_with_index<int, " \
         "at::native::arange_cuda_out(c10::Scalar const&)::{lambda()#1}>"
MEMCPY = "Memcpy DtoH (Device -> Pageable)"
NAMES = ("filter_device_ms", "groupby_device_ms", "sortby_device_ms",
         "plane_copy_device_ms", "program_host_ms", "idle_in_program_ms")

# Two calls.  Host spans (us): query 0-100 holds filter 10-40 (planes.split
# 12-20, radix.sort_passes 20-30), group_by 40-90 (planes.join 50-60) and
# sort_by 90-98; to_host 110-150 holds to_host.wait 112-148.
SPANS = [("query", 0, 100, 0, None), ("query.filter", 10, 40, 1, 0),
         ("planes.split", 12, 20, 2, 1), ("radix.sort_passes", 20, 30, 3, 1),
         ("query.group_by", 40, 90, 4, 0), ("planes.join", 50, 60, 5, 4),
         ("query.sort_by", 90, 98, 6, 0), ("to_host", 110, 150, 7, None),
         ("to_host.wait", 112, 148, 8, 7)]
# (event, launch us): each device event launched inside the span noted
SPAN_EVENTS = [((KV, 20, 30, trace.KERNEL), 15),          # planes.split
               ((KV, 30, 60, trace.KERNEL), 25),          # sort_passes
               ((ATEN, 60, 80, trace.KERNEL), 45),        # group_by
               ((ATEN, 80, 90, trace.KERNEL), 55),        # planes.join
               ((ATEN, 100, 104, trace.KERNEL), 95),      # sort_by
               ((MEMCPY, 120, 121, trace.MEMCPY), 113),   # to_host.wait
               ((ATEN, 130, 132, trace.KERNEL), 105),     # no span open
               ((ATEN, 140, 141, trace.KERNEL), None)]    # no launch record
FIRST = [(KV, 0, 3000, trace.KERNEL), (ATEN, 3000, 4000, trace.KERNEL),
         (ARANGE, 4000, 4500, trace.KERNEL),
         ("Memset (Device)", 5000, 5001, trace.MEMSET)]


def _run(cell_name, events, calls, enqueue=(1.0, 3.0),
         device="NVIDIA H100 80GB HBM3"):
    span = max(b for _, _, b, _ in events) - min(a for _, a, _, _ in events)
    reading = core.Reading(trace.Trace(events, span, calls), list(enqueue),
                           {}, device)
    res = core.Result(1.0, calls, 1.0, [1.0], 0, device, {}, 1, 0, reading)
    return result.Run(spec.cell(cell_name), res, 1.0)


def _span_run(cell_name="q1-sf10", span_list=SPANS, first=FIRST):
    """A traced run whose stretch with spans on is the synthetic one."""
    ev = [e for e, _ in SPAN_EVENTS]
    run = _run(cell_name, first, 2)
    run.result.span_stretch = spans.SpanTrace(
        trace.Trace(ev, 121, 2), [t for _, t in SPAN_EVENTS], list(span_list))
    return run


def _read(name, run):
    return run.cell.reader(name).read(run)


def test_innermost_span_over_time():
    # a parent and its child open at one time; a sibling opens as the
    # parent closes
    s = [("a", 0, 10, 0, None), ("b", 0, 5, 1, 0), ("c", 10, 20, 2, None)]
    assert spans._innermost(s) == ([0, 5, 10, 20], [1, 0, 2, None])


def test_span_readers_on_a_synthetic_stretch():
    run = _span_run()
    # device us under each step (its own and its children's), two calls
    assert _read("filter_device_ms", run) == pytest.approx(40 / 2e3)
    assert _read("groupby_device_ms", run) == pytest.approx(30 / 2e3)
    assert _read("sortby_device_ms", run) == pytest.approx(4 / 2e3)
    # planes.split's 10 and planes.join's 10
    assert _read("plane_copy_device_ms", run) == pytest.approx(20 / 2e3)
    # query 100 + to_host 40, less to_host.wait's 36
    assert _read("program_host_ms", run) == pytest.approx(104 / 2e3)
    # gaps 90-100 (sort_by 8, query 2), 104-120 (caller 6, to_host 2,
    # wait 8), 121-130 and 132-140 (wait 9 and 8)
    assert _read("idle_in_program_ms", run) == pytest.approx(37 / 2e3)
    st = spans.stretch(run)
    att = spans.attribute(st)
    assert att.caller_device_us == 3 and att.caller_idle_us == 6
    assert att.idle_us == [2, 0, 0, 0, 0, 0, 8, 2, 25]
    table = spans.span_table(st, run.traced.trace)
    assert table["span_device_share"] == pytest.approx(100 * 75 / 78)
    assert table["unlaunched_events"] == 1 and table["calls"] == 2
    assert table["spans"]["planes.split"] == {
        "device_ms": pytest.approx(10 / 2e3), "idle_ms": 0}
    assert table["caller"]["idle_ms"] == pytest.approx(6 / 2e3)
    assert set(table["first_stretch"]) == {"calls", "busy_ms", "idle_share"}


def test_span_readers_without_spans_read_nothing():
    run = _span_run()
    run.result.span_stretch = None  # a program without spans
    assert all(_read(n, run) is None for n in NAMES)
    run = _span_run(span_list=[])  # spans on, none recorded
    assert all(_read(n, run) is None for n in NAMES)
    # an untraced run takes no stretch
    run = _run("q1-sf10", FIRST, 2)
    run.result.reading = None
    assert all(_read(n, run) is None for n in NAMES)
    assert run.result.span_stretch is None
    # a sort records no query step and no word plane of its own
    run = _span_run("kvsort-u32-2p27",
                    span_list=[("sort_kv", 0, 150, 0, None)])
    for n in NAMES[:4]:
        assert _read(n, run) is None, n
    assert _read("program_host_ms", run) == pytest.approx(150 / 2e3)


def test_a_program_without_spans_takes_no_stretch(small_cell, monkeypatch):
    """Where the program has no ``profiling.take_spans`` (the port before
    its spans), no stretch is taken and nothing is made."""
    from radix_sort_tpu_torch.utils import profiling

    cell = small_cell("q1-sf10", lineitem_rows=1000)
    monkeypatch.delattr(profiling, "take_spans")
    monkeypatch.setattr(type(cell), "mix", property(
        lambda self: pytest.fail("inputs made for a program without spans")))
    assert spans.take(cell, 1, "cpu") is None


def test_the_span_stretch_leaves_the_other_readers_as_they_were():
    for cell in ("q1-sf10", "kvsort-u32-2p27"):
        plain = _run(cell, FIRST, 2)
        plain.result.span_stretch = None
        with_spans = _span_run(cell)
        a = result.assemble(plain.cell, plain.result, 1.0, True, "gpu")
        b = result.assemble(plain.cell, with_spans.result, 1.0, True, "gpu")
        assert a["breakdown"] == b["breakdown"]
        assert a["device"] == b["device"]
        assert set(a) == set(b)
        assert b["metrics"] == {**a["metrics"], **{
            k: v for k, v in b["metrics"].items() if k in NAMES}}
        assert not set(a["metrics"]) & set(NAMES)
        assert set(NAMES) & set(b["metrics"])


def test_span_breakdown_goes_to_standard_error(small_cell, capsys):
    """A traced run on the CPU: the stretch is taken once from the
    program, its table is one line of standard error, and every span
    metric of the cell is read from it."""
    for name, sizes in (("q1-sf10", {"lineitem_rows": 20_000}),
                        ("kvsort-u32-2p27", {"n": 1 << 12})):
        cell = small_cell(name, **sizes)
        res = core.drive(cell, 2**31 + 11, 0.2, True, "cpu", time.time())
        line = result.assemble(cell, res, res.ready_s, True, "cpu")
        assert line["correct"]
        err = [t for t in capsys.readouterr().err.splitlines()
               if t.startswith("span_breakdown ")]
        assert len(err) == 1, err
        table = json.loads(err[0].split(" ", 1)[1])
        assert table["unlaunched_events"] == 0
        assert table["span_device_share"] > 0
        assert set(table["first_stretch"]) == {"calls", "busy_ms",
                                               "idle_share"}
        wanted = {m["name"] for m in cell.per_layer
                  if m["source"] == "program_span"}
        assert wanted and wanted <= set(line["metrics"]), line["metrics"]
        assert res.span_stretch.spans
        assert "span_breakdown" not in line


@pytest.mark.cuda
@pytest.mark.parametrize("name,sizes", [
    ("kvsort-u32-2p27", {"n": 1 << 22}),
    ("q1-sf10", {"lineitem_rows": 1 << 22})])
def test_spans_account_for_the_device_work(small_cell, name, sizes):
    """On the card: every device event of the stretch with spans on is
    matched to its launch, at least 95% of device-busy time was launched
    inside a span, and each span metric of the cell is read."""
    import torch

    cell = small_cell(name, **sizes)
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    res = core.drive(cell, 2147483997, 1.0, True, "cuda", time.time())
    run = result.Run(cell, res, 1.0)
    st = spans.stretch(run, seed=2147483997)
    assert res.wrong == 0 and st is not None
    table = spans.span_table(st, run.traced.trace)
    assert table["unlaunched_events"] == 0, table
    assert table["span_device_share"] >= 95.0, table
    for m in cell.per_layer:
        if m["source"] == "program_span":
            assert cell.reader(m["name"]).read(run) is not None, m["name"]


def test_span_metrics_are_the_cells_they_read():
    q1 = {m["name"] for m in spec.cell("q1-sf10").per_layer}
    kv = {m["name"] for m in spec.cell("kvsort-u32-2p27").per_layer}
    assert set(NAMES) <= q1
    assert set(NAMES) & kv == {"program_host_ms", "idle_in_program_ms"}
    for m in spec.load()["per_layer"]:
        if m["name"] in NAMES:
            assert m["source"] == "program_span" and m["workloads"]
