"""The port's harness layer on device="cpu": the 5-phase task lifecycle,
runner fan-out, size guard, CSV schema, CLI options, statistics, profiling
helpers and the native-baseline bridge, as tests/test_harness.py checks
the JAX package's, plus parity of the sorted results with the JAX
harness's."""

import dataclasses
import io
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from radix_sort_tpu import datasets as jds, harness as jharness
from radix_sort_tpu import SortConfig as JSortConfig
from radix_sort_tpu.utils import cli as jcli, csvio as jcsvio
from radix_sort_tpu_torch import SortConfig, datasets, dtypes as tdt, harness
from radix_sort_tpu_torch.status import EngineError, OperationStatus
from radix_sort_tpu_torch.utils import (cli, csvio, native_baseline,
                                        profiling, stats)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _opts(**kw):
    base = dict(num_elements=2048, iterations=2)
    base.update(kw)
    return cli.RadixSortOptions(**base)


def test_sort_task_lifecycle():
    task = harness.SortTask(np.uint32, datasets.Random(np.uint32),
                            options=_opts(), device="cpu")
    res = harness.run_compute_task(task)
    assert res.valid
    assert res.status is OperationStatus.OK
    assert res.row.num_elements == 2048
    assert res.row.datatype == "u32"
    assert res.row.dataset == "Random"
    assert res.row.engine == "radix"
    assert res.row.avg_total_gpu > 0
    assert res.row.avg_total_stl_cpu > 0
    assert res.row.mkeys_per_sec > 0
    assert res.row.roofline_frac == 0.0  # no card, no bandwidth to hold to


def test_task_needs_an_explicit_device():
    with pytest.raises(TypeError):
        harness.SortTask(np.uint32, datasets.Zeros(np.uint32))
    with pytest.raises(TypeError):
        harness.run_all(_opts())


@pytest.mark.parametrize("dtype,engine,with_values", [
    (np.uint32, "merge", False), (np.int32, "merge", False),
    (np.uint32, "radix", True), (np.int64, "radix", True),
    (np.uint64, "merge", True)], ids=["u32-merge", "i32-merge", "u32-kv",
                                      "i64-kv", "u64-kv-merge"])
def test_sort_task_matches_jax_harness(dtype, engine, with_values):
    """The same task through both harnesses: the sorted keys (and the
    stable permutation) are equal, and both validate."""
    jengine = {"merge": "pallas_merge", "radix": "auto"}[engine]
    n = 3 * 16384 + 5
    opts = _opts(num_elements=n, iterations=1)
    task = harness.SortTask(dtype, datasets.RandomDistributed(dtype, seed=4),
                            options=opts, config=SortConfig(engine=engine),
                            with_values=with_values, device="cpu")
    jtask = jharness.SortTask(dtype, jds.RandomDistributed(dtype, seed=4),
                              options=jcli.RadixSortOptions(
                                  **dataclasses.asdict(opts)),
                              config=JSortConfig(engine=jengine),
                              with_values=with_values)
    for t in (task, jtask):
        t.init_resources()
        t.compute_gpu()
        assert t.validate_results()
    got = task._result[0] if with_values else task._result
    want = jtask._result[0] if with_values else jtask._result
    np.testing.assert_array_equal(tdt.tensor_to_numpy(got), np.asarray(want))
    if with_values:
        np.testing.assert_array_equal(task._result[1].numpy(),
                                      np.asarray(jtask._result[1]))


def test_validation_catches_an_unstable_permutation():
    task = harness.SortTask(np.uint32, datasets.Zeros(np.uint32),
                            options=_opts(), device="cpu")
    task.init_resources()
    task.compute_gpu()
    assert task.validate_results()
    task._result = (task._result[0], task._result[1].flip(0))
    assert not task.validate_results()


def test_runner_fan_out_filtered():
    opts = _opts(datatypes=("u32",), datasets=("Zeros", "Range"))
    results = harness.run_all(opts, dtypes_list=(np.uint32,), device="cpu")
    assert len(results) == 2
    assert all(r.valid for r in results)
    assert {r.row.dataset for r in results} == {"Zeros", "Range"}


def test_runner_all_types_small():
    opts = _opts(num_elements=256, datasets=("Random",))
    results = harness.run_all(opts, device="cpu")
    assert len(results) == 4  # u32, i32, u64, i64
    assert all(r.valid for r in results)
    assert {r.row.datatype for r in results} == {"u32", "i32", "u64", "i64"}


def test_max_elems_guard():
    task = harness.SortTask(np.uint32, datasets.Zeros(np.uint32),
                            options=_opts(num_elements=1 << 30),
                            device="cpu")
    with pytest.raises(EngineError):
        harness.run_compute_task(task)
    small = SortConfig(max_input_elems=1000)
    task = harness.SortTask(np.uint32, datasets.Zeros(np.uint32),
                            options=_opts(), config=small, device="cpu")
    with pytest.raises(EngineError):
        task.init_resources()


def test_phase_instrumentation_populates_columns():
    for dtype in (np.uint32, np.uint64):
        task = harness.SortTask(dtype, datasets.Random(dtype),
                                options=_opts(num_elements=4096),
                                device="cpu")
        task.init_resources()
        task.measure_phases()
        row = task.perf_row(True, "radix")
        assert row.avg_histogram > 0
        assert row.avg_scan > 0
        assert row.avg_reorder > 0
        assert row.avg_paste == 0.0  # folded into the scan


# ----------------------------------------------------------------- csvio

def test_csv_schema_matches_jax():
    assert csvio.REFERENCE_COLUMNS == jcsvio.REFERENCE_COLUMNS
    assert csvio.EXTENDED_COLUMNS == jcsvio.EXTENDED_COLUMNS
    fields = dict(avg_total_gpu=1.5, avg_total_stl_cpu=10.0,
                  avg_total_rdx_cpu=12.0, mkeys_per_sec=100.0,
                  roofline_frac=0.5, engine="merge")
    for extended in (False, True):
        a, b = io.StringIO(), io.StringIO()
        csvio.write_rows([csvio.PerfRow(1024, "u32", "Zeros", **fields)], a,
                         extended=extended)
        jcsvio.write_rows([jcsvio.PerfRow(1024, "u32", "Zeros", **fields)], b,
                          extended=extended)
        assert a.getvalue() == b.getvalue()
    lines = a.getvalue().strip().split("\n")
    assert lines[1].startswith("1024,u32,Zeros,0,0,0,0,1.5,10,12,100,0.5,")


def test_csv_timestamped_path(tmp_path):
    path = csvio.write_csv([csvio.PerfRow(8, "u32", "Zeros")],
                           directory=str(tmp_path))
    assert path.startswith(str(tmp_path))
    assert os.path.basename(path).startswith("radix_")
    assert path.endswith(".csv")
    with open(path) as f:
        assert f.readline().startswith("NumElements,")


# ------------------------------------------------------------------- cli

def test_cli_defaults_match_jax():
    assert cli.parse_options([]) == cli.RadixSortOptions()
    o, jo = cli.parse_options([]), jcli.parse_options([])
    assert dataclasses.asdict(o) == dataclasses.asdict(jo)
    assert o.num_elements == 1 << 25  # reference default


def test_cli_reference_flags():
    o = cli.parse_options([
        "--num-elements", "4096", "--perf-to-stdout", "--perf-to-csv",
        "--perf-csv-to-stdout", "-v"])
    assert o.num_elements == 4096
    assert o.perf_to_stdout and o.perf_to_csv and o.perf_csv_to_stdout
    assert o.verbose


def test_cli_engines_are_the_ports():
    o = cli.parse_options(["--engine", "merge", "--datatypes", "u32,u64",
                           "--datasets", "Zeros", "--iterations", "3"])
    assert o.engine == "merge"
    assert o.datatypes == ("u32", "u64")
    assert o.datasets == ("Zeros",)
    assert o.iterations == 3
    for engine in cli.ENGINE_CHOICES:
        assert cli.parse_options(["--engine", engine]).engine == engine
    with pytest.raises(SystemExit):
        cli.parse_options(["--engine", "pallas_merge"])


# ------------------------------------------------------------------ stats

def test_statistics_first_sample_sets_min():
    st = stats.Statistics()
    st.update(5.0)
    assert st.min == 5.0 and st.max == 5.0 and st.avg == 5.0
    st.update(3.0)
    st.update(7.0)
    assert st.min == 3.0 and st.max == 7.0 and st.n == 3
    assert st.avg == pytest.approx(5.0)
    assert st.as_dict()["sum"] == 15.0


def test_timer_and_time_callable():
    t = stats.Timer()
    t.start()
    t.stop()
    assert t.elapsed_ms() >= 0
    with pytest.raises(RuntimeError):
        stats.Timer().stop()
    calls = []
    st = stats.time_callable_ms(lambda: calls.append(1), iterations=3,
                                warmup=1)
    assert st.n == 3 and len(calls) == 4


# -------------------------------------------------------------- profiling

def test_profiling_on_the_cpu(tmp_path):
    calls = []
    assert profiling.time_ms(lambda: calls.append(1), "cpu", reps=3) >= 0
    assert len(calls) == 4
    assert profiling.device_hbm_gbs("cpu") is None
    assert profiling.roofline(10**9, 1.0, "cpu") is None
    jb = __import__("radix_sort_tpu.utils.profiling", fromlist=["x"])
    assert profiling.sort_min_bytes(1 << 20, np.uint64, 8, 4) == \
        jb.sort_min_bytes(1 << 20, np.uint64, 8, 4)
    with profiling.trace(str(tmp_path)) as prof:
        torch.arange(1000).sum()
        with profiling.span("outer", rows=1000):
            with profiling.span("inner"):
                torch.arange(1000).sum()
    assert prof.key_averages()
    # the spans sit in the profiler's own trace file, on its time base:
    # each over the ops it ran, and taken (none left), spans off again
    (path,) = tmp_path.glob("*.pt.trace.json")
    rows = json.loads(path.read_text())["traceEvents"]
    spans = {r["name"]: r for r in rows if r.get("cat") == "span"}
    assert set(spans) == {"outer", "inner"}
    assert spans["outer"]["args"]["rows"] == 1000
    assert spans["inner"]["args"]["parent"] == spans["outer"]["args"]["id"]
    out = spans["outer"]
    lo, hi = out["ts"], out["ts"] + out["dur"]
    sums = [(r["ts"], r["ts"] + r["dur"]) for r in rows
            if r.get("name") == "aten::sum"]
    before = [a for a, b in sums if b <= lo]
    inside = [a for a, b in sums if lo <= a and b <= hi]
    assert before and inside and len(before) + len(inside) == len(sums)
    assert profiling.take_spans() == []
    assert profiling.span("after") is profiling.span("after2")


# -------------------------------------------------------- native baseline

def test_native_baseline_bridge(tmp_path, monkeypatch):
    """Built from native/ into a scratch directory: the bridge's sorts
    equal numpy's, and the harness times it in place of the golden radix
    sort; without the library the harness uses golden.cpu_radix_sort."""
    monkeypatch.setattr(native_baseline, "LIBRARY", tmp_path / "none.so")
    native_baseline._load.cache_clear()
    try:
        assert not native_baseline.available()
        task = harness.SortTask(np.int64, datasets.Random(np.int64),
                                options=_opts(), device="cpu")
        task.init_resources()
        task.compute_cpu()  # golden radix sort instead
        assert task.cpu_runtimes.radix.n == 2
        cxx = shutil.which("g++")
        if cxx is None:
            pytest.skip("no C++ compiler to build native/")
        lib = tmp_path / "libhostbaseline.so"
        subprocess.run([cxx, "-O2", "-std=c++20", "-fPIC", "-shared", "-o",
                        str(lib), os.path.join(REPO, "native",
                                               "host_baseline.cpp")],
                       check=True, timeout=300)
        monkeypatch.setattr(native_baseline, "LIBRARY", lib)
        native_baseline._load.cache_clear()
        assert native_baseline.available()
        rng = np.random.default_rng(0)
        for dtype in (np.uint32, np.int32, np.uint64, np.int64):
            info = np.iinfo(dtype)
            x = rng.integers(info.min, info.max, 5000, dtype=dtype)
            keep = x.copy()
            np.testing.assert_array_equal(native_baseline.std_sort(x),
                                          np.sort(x))
            np.testing.assert_array_equal(native_baseline.radix_sort(x),
                                          np.sort(x))
            np.testing.assert_array_equal(x, keep)
        k, v = native_baseline.radix_sort_kv_u32(
            np.array([5, 1, 5, 1, 5], np.uint32), np.arange(5))
        np.testing.assert_array_equal(k, [1, 1, 5, 5, 5])
        np.testing.assert_array_equal(v, [1, 3, 0, 2, 4])
        task.compute_cpu()
        assert task.cpu_runtimes.radix.n == 2
    finally:
        native_baseline._load.cache_clear()


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.uint64, np.int64],
                         ids=["u32", "i32", "u64", "i64"])
@pytest.mark.parametrize("name", ["Zeros", "RandomDistributed", "Random",
                                  "Range", "InvertedRange"])
def test_radix_passes_run_is_the_sorts_skip_rule(dtype, name):
    """The harness's roofline counts the passes the radix engine runs on
    the row's keys: those that no single digit fills in the sort's own
    digit table (pass_histograms)."""
    from radix_sort_tpu_torch.ops import cuda_radix, stream

    ds = next(d for d in datasets.make_datasets(dtype, seed=0)
              if d.name == name)
    keys = ds.generate(3000)
    planes = stream.key_word_planes(tdt.to_sortable(
        tdt.tensor_from_numpy(keys, "cpu")))
    hist = cuda_radix.pass_histograms(planes, (4,) * len(planes), 256)
    runs = int((hist.max(dim=1).values < keys.size).sum())
    assert profiling.radix_passes_run(keys) == runs
    assert profiling.sort_min_bytes(3000, dtype, passes=runs) == \
        runs * 3000 * 3 * np.dtype(dtype).itemsize
