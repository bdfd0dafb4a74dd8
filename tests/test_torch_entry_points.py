"""The port's measurement entry points (bench_torch.py,
scripts/torch_benchmark.py, scripts/torch_baseline_configs.py,
scripts/torch_scaling_bench.py) against the JAX package and the JAX
programs, on the CPU (``--device cpu``) at small sizes.

The headline's keys and metric are bench.py's; the sweep enumerates the
rows of scripts/benchmark.py and writes utils/csvio's header; configs 1-5
give the JAX operators' results on the same numpy inputs, under the JAX
script's record names (config 5 on 4 gloo ranks); the scaling bench is
valid at 1, 2 and 4 gloo ranks.  The ``cuda`` cases run the headline and
a sweep row on the card."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_ranks as R
from radix_sort_tpu import datasets as jds_lib, sort as jsort
from radix_sort_tpu import sort_kv as jsort_kv
from radix_sort_tpu import datasets_device as jdd
from radix_sort_tpu.ops import aggregate as jagg, filter as jfilt
from radix_sort_tpu.ops import join as jjoin
from radix_sort_tpu.parallel import dist_ops as jops, dist_sort as jdsort
from radix_sort_tpu.parallel import mesh as jmesh
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu.utils import csvio as jcsvio
import radix_sort_tpu_torch as rt
from radix_sort_tpu_torch.parallel import mesh as mesh_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the rank processes start from this path, so they import the scripts too
sys.path.insert(0, os.path.join(REPO, "scripts"))

import bench  # noqa: E402  (the JAX headline; imports no JAX at the top)
import bench_torch  # noqa: E402
import torch_baseline_configs as tbc  # noqa: E402
import torch_benchmark  # noqa: E402
import torch_scaling_bench  # noqa: E402

SMALL = 12
CPU = torch.device("cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _last_json(out: str):
    return json.loads(out.strip().splitlines()[-1])


def _jtable(cols):
    return JTable({k: jnp.asarray(v) for k, v in cols.items()})


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ------------------------------------------------------------ the headline

def test_headline_line_data_and_metric_match_bench_py(capsys):
    assert bench_torch.main(["--log2n", str(SMALL), "--device", "cpu"]) == 0
    rec = _last_json(capsys.readouterr().out)
    assert bench_torch.LOG2N == bench.LOG2N == 25
    assert bench_torch.BASELINE_MKEYS_PER_SEC == bench.BASELINE_MKEYS_PER_SEC
    assert rec["metric"] == f"u32_sort_2^{SMALL}_uniform_throughput"
    assert rec["unit"] == "Mkeys/s" and rec["engine"] == "auto"
    assert rec["value"] > 0 and rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.BASELINE_MKEYS_PER_SEC, abs=0.01)
    assert rec["ms_min"] <= rec["ms_median"] <= rec["ms_max"]
    assert rec["calls"] == bench_torch.CALLS and isinstance(
        rec["suspect"], bool)
    assert rec["torch_sort_ms"] > 0 and rec["name"] == "cpu"
    assert "power_limit_w" in rec
    # the keys are bench.py's bytes, and both sort them alike
    n = 1 << SMALL
    keys = rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n)
    jkeys = jds_lib.RandomDistributed(np.uint32, seed=0).generate(n)
    np.testing.assert_array_equal(keys, jkeys)
    got = rt.dtypes.tensor_to_numpy(
        rt.sort(rt.dtypes.tensor_from_numpy(keys, CPU)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jsort)(
        jnp.asarray(jkeys))))


def test_headline_exits_nonzero_when_two_outputs_swap(monkeypatch, capsys):
    real = rt.sort

    def swapped(keys, config=rt.DEFAULT_CONFIG, engine=None):
        out = real(keys, config, engine)
        c = rt.dtypes.as_container(out)
        c[[0, -1]] = c[[-1, 0]].clone()
        return out

    monkeypatch.setattr(rt, "sort", swapped)
    with pytest.raises(SystemExit) as e:
        bench_torch.main(["--log2n", str(SMALL), "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert "validation failed" in str(e.value.code)
    assert capsys.readouterr().out.strip() == ""  # no result line


@pytest.mark.parametrize("entry", ["bench_torch", "torch_benchmark",
                                   "torch_baseline_configs",
                                   "torch_scaling_bench"])
def test_entry_points_raise_without_a_card(entry):
    """Each runs on the card by default; without one it raises before any
    work, and runs on the CPU only under --device cpu."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    module = {"bench_torch": bench_torch, "torch_benchmark": torch_benchmark,
              "torch_baseline_configs": tbc,
              "torch_scaling_bench": torch_scaling_bench}[entry]
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main([])


# ----------------------------------------------------------------- the sweep

def test_sweep_rows_and_csv_header_match_the_jax_sweep(tmp_path, capsys):
    argv = ["--min-log2", "6", "--max-log2", "10", "--step", "2",
            "--datatypes", "u32,i64", "--device", "cpu", "--perf-to-stdout",
            "--perf-to-csv", "--csv-dir", str(tmp_path)]
    results = torch_benchmark.sweep(torch_benchmark.build_parser()
                                    .parse_args(argv))
    # scripts/benchmark.py: n from 2^max down by step, then the dtypes,
    # then datasets_device.ALL_NAMES
    want = [(logn, d, name) for logn in range(10, 6 - 1, -2)
            for d in ("u32", "i64") for name in jdd.ALL_NAMES]
    got = [(r.row.num_elements.bit_length() - 1, r.row.datatype,
            r.row.dataset) for r in results]
    assert got == want
    assert all(r.valid for r in results)
    assert all(r.row.engine == "radix" for r in results)
    # the phase columns and the CPU baselines are filled
    assert all(r.row.avg_histogram > 0 and r.row.avg_reorder > 0
               and r.row.avg_total_stl_cpu > 0 for r in results)
    header = ",".join(jcsvio.EXTENDED_COLUMNS)
    (csv,) = tmp_path.glob("radix_*.csv")
    lines = csv.read_text().splitlines()
    assert lines[0] == header and len(lines) == len(want) + 1
    out = capsys.readouterr().out.splitlines()
    assert out[-len(want) - 1] == header


def test_sweep_refuses_the_reference_csv_directory():
    args = torch_benchmark.build_parser().parse_args(
        ["--perf-to-csv", "--csv-dir", os.path.join(REPO, "Performance"),
         "--device", "cpu"])
    with pytest.raises(SystemExit, match="Performance"):
        torch_benchmark.sweep(args)


# --------------------------------------------------------------- configs

def test_config_record_names_are_the_jax_scripts():
    """The record names of scripts/baseline_configs.py at 2^12 (configs 2-4
    suffixed with the size, as it does off 2^20)."""
    src = open(os.path.join(REPO, "scripts", "baseline_configs.py")).read()
    for stem in ('"config1_u32_keyonly_1M_uniform"',
                 'f"config2_kv_{dname}_{ds.name}"',
                 '"config3_filter_aggregate_1M"',
                 '"config4_hash_join_1M_probe_256K_build"',
                 '"config5_multihost_query"', 'f"_2^{log2n}"'):
        assert stem in src


def test_configs_refuse_the_reference_results_file():
    args = tbc.build_parser().parse_args(
        ["1", "--device", "cpu", "--out",
         os.path.join(REPO, "BASELINE_RESULTS.json")])
    with pytest.raises(SystemExit, match="BASELINE_RESULTS"):
        tbc.run_configs(args)


@pytest.fixture(scope="module")
def config_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("configs") / "results.json"
    args = tbc.build_parser().parse_args(
        ["1", "2", "3", "4", "--device", "cpu", "--cfg2-log2n", str(SMALL),
         "--cfg34-log2n", str(SMALL), "--out", str(out)])
    records = tbc.run_configs(args)
    return records, json.loads(out.read_text())


def test_configs_1_to_4_records_are_valid_and_written_through(
        config_records):
    records, written = config_records
    s = f"_2^{SMALL}"
    want = (["config1_u32_keyonly_1M_uniform"]
            + [f"config2_kv_{d}_{ds}{s}" for d in ("u32", "u64")
               for ds in ("Zeros", "Random", "Range", "InvertedRange")]
            + [f"config3_filter_aggregate_1M{s}",
               f"config4_hash_join_1M_probe_256K_build{s}"])
    assert list(records) == want and list(written) == want
    for name, r in records.items():
        assert r["valid"], name
        assert r["device"] == "cpu" and r["torch_sort_ms"] > 0, name
    assert records["config1_u32_keyonly_1M_uniform"]["n"] == 1 << 20


def test_config1_keys_sort_as_in_jax():
    n = 1 << SMALL
    keys = rt.datasets.RandomDistributed(np.uint32, seed=0).generate(n)
    got = rt.dtypes.tensor_to_numpy(rt.sort(
        rt.dtypes.tensor_from_numpy(keys, CPU)))
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jsort)(
        jnp.asarray(keys))))


@pytest.mark.parametrize("dt", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_config2_sorts_match_jax_sort_kv(dt):
    n = 1 << SMALL
    vals = np.arange(n, dtype=np.int32)
    jfn = jax.jit(jsort_kv)
    seen = []
    for ds_name, host, kd in tbc.config2_keys(dt, n, CPU):
        seen.append(ds_name)
        ko, vo = rt.sort_kv(kd, torch.from_numpy(vals))
        jk, jv = jfn(jnp.asarray(host), jnp.asarray(vals))
        np.testing.assert_array_equal(rt.dtypes.tensor_to_numpy(ko),
                                      np.asarray(jk))
        np.testing.assert_array_equal(vo.numpy(), np.asarray(jv))
        assert tbc.check_stable_kv(kd, ko, vo)
    assert seen == ["Zeros", "Random", "Range", "InvertedRange"]


def test_check_stable_kv_rejects_what_is_not_the_stable_sort():
    keys = torch.tensor([3, 1, 3, 2, 1], dtype=torch.int32)
    ko, vo = rt.sort_kv(keys, torch.arange(5, dtype=torch.int32))
    assert tbc.check_stable_kv(keys, ko, vo)
    assert not tbc.check_stable_kv(keys, ko, vo[[1, 0, 2, 3, 4]])  # unstable
    assert not tbc.check_stable_kv(keys, ko.flip(0), vo.flip(0))  # unsorted
    assert not tbc.check_stable_kv(keys, ko, vo + 7)  # out of range
    wrong = vo.clone()
    wrong[2] = 0  # a key-2 row taken from a key-3 row
    assert not tbc.check_stable_kv(keys, ko, wrong)


def test_config3_matches_jax_filter_and_aggregate():
    cols = tbc.config3_inputs(SMALL)
    got = tbc.config3_query(rt.Table.from_numpy(cols, device=CPU),
                            rt.DEFAULT_CONFIG)
    want = jax.jit(lambda t: jagg.hash_aggregate(
        jfilt.filter_expr(t, "k", "lt", 500), "k",
        {"n": ("count", None), "s": ("sum", "x")}))(_jtable(cols))
    _same(got.to_numpy(), want.to_numpy())


def test_config4_matches_jax_hash_join():
    pcols, bcols = tbc.config4_inputs(SMALL)
    got, stats = tbc.config4_query(rt.Table.from_numpy(pcols, device=CPU),
                                   rt.Table.from_numpy(bcols, device=CPU),
                                   rt.DEFAULT_CONFIG)
    want, jstats = jax.jit(lambda p, b: jjoin.hash_join(p, b, "k"))(
        _jtable(pcols), _jtable(bcols))
    assert int(stats["match_count"]) == int(jstats["match_count"])
    assert not bool(stats["overflow"]) and not bool(jstats["overflow"])
    _same(got.to_numpy(), want.to_numpy())


CONFIG5_N = R.D * (1 << 10)


def test_config5_on_four_gloo_ranks_matches_jax():
    """The script's config 5 operators and checks on 4 gloo CPU ranks,
    against the JAX operators on 4 CPU devices with the same probe keys;
    then its record, with its own spawn of 4 ranks."""
    port = mesh_lib.run_ranks(R.config5_script_case, R.D, backend="gloo",
                              device="cpu", args=(CONFIG5_N,), threads=1)
    pk = tbc.config5_probe(CONFIG5_N)
    bk = np.arange(tbc.ZIPF_BUILD, dtype=np.uint32)
    pt = _jtable({"k": pk, "pv": np.arange(CONFIG5_N, dtype=np.int32)})
    bt = _jtable({"k": bk, "bv": (bk * 7).astype(np.int32)})
    jm = jmesh.make_mesh(R.D)
    jj, jst = jops.dist_hash_join(pt, bt, "k", mesh=jm)
    ja, _ = jops.dist_hash_aggregate(pt, "k", {"n": ("count", None)},
                                     mesh=jm)
    jk, jv, _ = jdsort.dist_sort_kv(jnp.asarray(pk),
                                    jnp.asarray(np.arange(CONFIG5_N,
                                                          dtype=np.int32)),
                                    mesh=jm)
    for p in port:
        assert all(p["checks"].values()), p["checks"]
    p0 = port[0]
    _same(p0["joined"], jj.to_numpy())
    assert p0["matches"] == int(jst["match_count"]) == CONFIG5_N
    _same(p0["agg"], ja.to_numpy())
    assert not any(p["overflow"] for p in port)
    np.testing.assert_array_equal(np.concatenate([p["ks"] for p in port]),
                                  np.asarray(jk))
    np.testing.assert_array_equal(np.concatenate([p["vs"] for p in port]),
                                  np.asarray(jv))

    ((name, rec),) = tbc.config5("cpu", R.D, "gloo", 1 << 10)
    assert name == "config5_multihost_query"
    assert rec["valid"] and rec["join_valid"] and rec["agg_valid"] \
        and rec["sort_valid"]
    assert (rec["devices"], rec["rows"], rec["transport"]) == (
        R.D, CONFIG5_N, "gloo-cpu")


def test_config5_refuses_more_nccl_ranks_than_cards():
    with pytest.raises(ValueError, match="cards"):
        list(tbc.config5("cuda", torch.cuda.device_count() + 1, "nccl"))


# ---------------------------------------------------------- weak scaling

def test_scaling_at_one_two_and_four_gloo_ranks(capsys):
    argv = ["--device", "cpu", "--mesh-sizes", "1,2,4", "--rows-per-dev",
            "1024", "--check-ops"]
    assert torch_scaling_bench.main(argv) == 0
    records = _last_json(capsys.readouterr().out)
    assert [r["devices"] for r in records] == [1, 2, 4]
    assert [r["rows"] for r in records] == [1024, 2048, 4096]
    for r in records:
        assert r["valid"] and r["agg_valid"] and r["join_valid"], r
        assert r["transport"] == "gloo-cpu" and r["device"] == "cpu"
    assert records[0]["weak_scaling_eff"] == 1.0


def test_scaling_refuses_more_nccl_ranks_than_cards():
    with pytest.raises(ValueError, match="cards"):
        torch_scaling_bench.scaling([torch.cuda.device_count() + 1], 64,
                                    False, "nccl", "cuda")


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_cuda_headline_at_2_20(cuda_device):
    from radix_sort_tpu_torch.ops import cuda_radix

    before = cuda_radix.launch_counts()
    rec = bench_torch.run(20, "auto", str(cuda_device))
    after = cuda_radix.launch_counts()
    assert rec["metric"] == "u32_sort_2^20_uniform_throughput"
    assert rec["value"] > 0 and rec["power_limit_w"] is not None
    assert after["onesweep_pass"] > before["onesweep_pass"]


@pytest.mark.cuda
def test_cuda_sweep_row(cuda_device, tmp_path):
    args = torch_benchmark.build_parser().parse_args(
        ["--min-log2", "20", "--max-log2", "20", "--datatypes", "u32",
         "--datasets", "RandomDistributed", "--device", str(cuda_device),
         "--perf-to-csv", "--csv-dir", str(tmp_path)])
    (res,) = torch_benchmark.sweep(args)
    assert res.valid and res.row.avg_reorder > 0
    assert 0 < res.row.roofline_frac <= 1.0
