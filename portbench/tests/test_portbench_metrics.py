"""The readers of the metrics on synthetic runs: what each reads from a
trace, the enqueue times and the counters."""

import pytest

from portbench import core, result, spec, trace

KV = "void (anonymous namespace)::rank_scatter_kernel<256, 32, true, " \
     "unsigned int, 4>((anonymous namespace)::DigitPlanes, long)"
ATEN = "void at::native::vectorized_elementwise_kernel<4, " \
       "at::native::CUDAFunctor_add<long>>(int)"
ARANGE = "void (anonymous namespace)::elementwise_kernel_with_index<int, " \
         "at::native::arange_cuda_out(c10::Scalar const&)::{lambda()#1}>"


def test_kernel_names_are_classed():
    assert not trace.is_library(KV) and trace.kind_of(KV) == trace.KERNEL
    assert trace.is_library(ATEN) and trace.is_library(ARANGE)
    assert trace.kind_of("Memset (Device)") == trace.MEMSET
    assert trace.kind_of("Memcpy DtoH (Device -> Pageable)") == trace.MEMCPY
    assert trace.kind_of("Event Sync") is None


def _run(cell_name, events, calls, enqueue=(), counters=None,
         device="NVIDIA H100 80GB HBM3"):
    span = max(b for _, _, b, _ in events) - min(a for _, a, _, _ in events)
    reading = core.Reading(trace.Trace(events, span, calls), list(enqueue),
                           counters or {}, device)
    res = core.Result(1.0, calls, 1.0, [1.0], 0, device, {}, 1, 0, reading)
    return result.Run(spec.cell(cell_name), res, 1.0)


def _read(name, run):
    return run.cell.reader(name).read(run)


def test_idle_share_and_roofline_from_synthetic_intervals():
    # two calls of 2^27 pairs, 4 ms busy each (a memset inside a kernel's
    # time counts once), 2 ms idle between: 8 of 10 ms busy
    ev = [("Memset (Device)", 0, 100, trace.MEMSET), (KV, 50, 4000,
                                                     trace.KERNEL),
          (KV, 6000, 10000, trace.KERNEL)]
    run = _run("kvsort-u32-2p27", ev, 2)
    assert _read("device_idle_share", run) == pytest.approx(20.0)
    # 2 * 2^27 * 8 B over 4 ms a call at 3.35 TB/s
    want = 100 * 2 * 2**27 * 8 / 3.35e12 / 4e-3
    assert _read("sort_roofline", run) == pytest.approx(want)
    assert _read("sort_roofline", _run("kvsort-u32-2p27", ev, 2,
                                       device="cpu")) is None


def test_glue_port_kernels_and_counts_per_call():
    ev = [(KV, 0, 3000, trace.KERNEL), (ATEN, 3000, 4000, trace.KERNEL),
          (ARANGE, 4000, 4500, trace.KERNEL),
          ("Memcpy DtoH (Device -> Pageable)", 4500, 4600, trace.MEMCPY)]
    run = _run("q1-sf10", ev, 2, enqueue=[1.0, 3.0])
    assert _read("port_kernel_ms", run) == pytest.approx(1.5)
    assert _read("glue_device_ms", run) == pytest.approx(0.75)
    assert _read("kernels_per_call", run) == pytest.approx(2.0)
    assert _read("host_enqueue_ms", run) == pytest.approx(2.0)


def test_nothing_to_read_is_left_out():
    run = _run("q1-sf10", [(KV, 0, 1, trace.KERNEL)], 1)
    run.result.reading.trace = trace.Trace([], 0.0, 1)
    for name in ("device_idle_share", "port_kernel_ms", "glue_device_ms",
                 "kernels_per_call"):
        assert _read(name, run) is None, name
    run.result.reading = None
    assert _read("host_enqueue_ms", run) is None


def test_gaps_are_named_by_the_op_that_ends_them():
    ev = [(KV, 0, 10, trace.KERNEL), ("Memset (Device)", 30, 31,
                                      trace.MEMSET),
          (KV, 31, 40, trace.KERNEL), ("Memset (Device)", 50, 51,
                                       trace.MEMSET)]
    t = trace.Trace(ev, 51, 2)
    assert trace.top_gaps(t) == [["before Memset (Device)",
                                  pytest.approx(30e-6)]]
    ops = dict((n, s) for n, s in trace.top_ops(t))
    assert ops[KV] == pytest.approx(19e-6)


def test_held_bytes_counts_device_storage_once():
    import torch

    cpu = torch.zeros(8, dtype=torch.int32)
    assert core.held_bytes({"keys": cpu, "values": None}) == 0
    assert core.held_bytes(None) == 0


NCCL = "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)"


def test_the_hot_rank_and_the_exchange_readers_on_four_ranks():
    # a call each: every rank's NCCL kernel runs until the slowest rank
    # (rank 2, 6 ms of its own work) is done, so device-busy time reads
    # alike; the work outside NCCL does not
    def rank(work_ms):
        return trace.Trace([(KV, 0, work_ms * 1e3, trace.KERNEL),
                            (NCCL, work_ms * 1e3, 7000, trace.KERNEL),
                            (ATEN, 7000, 8000, trace.KERNEL)], 10000, 1)

    traces = [rank(w) for w in (2, 3, 6, 3)]
    assert all(t.busy_us() == 8000 for t in traces)
    assert core.hot_rank(traces) == 2
    run = _run("dist-query-4x2p28", traces[2].events, 1,
               counters={"host_reads": 9.0})
    r = run.result.reading
    r.rank_traces, r.hot_rank = traces, 2
    assert _read("exchange_device_ms", run) == pytest.approx(1.0)
    # 7 ms of work on rank 2 against a mean of (3 + 4 + 7 + 4) / 4
    assert _read("rank_imbalance", run) == pytest.approx(7 / 4.5)
    assert _read("port_kernel_ms", run) == pytest.approx(6.0)
    assert _read("glue_device_ms", run) == pytest.approx(1.0)
    assert _read("host_reads_per_call", run) == 9.0
    line = result.assemble(run.cell, run.result, 1.0, True, "gpu")
    assert line["device"]["count"] == 4
    assert line["device"]["busy_s"] == pytest.approx(8e-3)
    assert all(n.startswith("rank 2: ")
               for n, _ in line["breakdown"]["device_ops"])


def test_the_exchange_readers_read_nothing_on_one_card():
    run = _run("dist-query-4x2p28", [(KV, 0, 1, trace.KERNEL)], 1)
    for name in ("exchange_device_ms", "rank_imbalance",
                 "host_reads_per_call"):
        assert _read(name, run) is None, name
