"""Parity of the PyTorch port's foundations with the JAX package: key
transforms, datasets, golden oracles, SortConfig, Table and convert.  Inputs
come from numpy with fixed seeds and go through both packages."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu import datasets as jds, dtypes as jdt, golden as jgold
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import convert, datasets as tds, dtypes as tdt
from radix_sort_tpu_torch import golden as tgold
from radix_sort_tpu_torch.table import Table

ALL_DTYPES = [np.uint32, np.int32, np.uint64, np.int64, np.float32,
              np.float64]
IDS = ["u32", "i32", "u64", "i64", "f32", "f64"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_package_imports_no_jax():
    """The port must run where JAX is absent: importing it (and every slice
    module) pulls in no jax module."""
    code = ("import sys, radix_sort_tpu_torch\n"
            "from radix_sort_tpu_torch.ops import aggregate, cuda_merge, "
            "cuda_radix, filter, join, partition, ranking, scan, sort, "
            "stream, topk, window\n"
            "from radix_sort_tpu_torch import _build, convert, harness, "
            "table, query, io, datasets_device\n"
            "from radix_sort_tpu_torch.utils import cli, csvio, "
            "native_baseline, profiling, stats\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('radix_sort_tpu.')]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=IDS)
def test_to_sortable_matches_jax(dtype):
    data = jds.RandomDistributed(dtype, seed=7).generate(2000)
    want = np.asarray(jdt.to_sortable_unsigned(jnp.asarray(data)))
    bits = tdt.to_sortable(tdt.tensor_from_numpy(data, "cpu"))
    assert bits.dtype == tdt.signed_container(dtype)
    got = bits.numpy().view(want.dtype)
    np.testing.assert_array_equal(got, want)
    # unsigned order of the bits is the key order
    order = np.argsort(got, kind="stable")
    np.testing.assert_array_equal(order, np.argsort(data, kind="stable"))
    back = tdt.tensor_to_numpy(tdt.from_sortable(bits, dtype))
    np.testing.assert_array_equal(back.view(np.uint8), data.view(np.uint8))
    np.testing.assert_array_equal(
        tdt.np_to_sortable_unsigned(data), jdt.np_to_sortable_unsigned(data))
    np.testing.assert_array_equal(
        tdt.np_from_sortable_unsigned(want, dtype).view(np.uint8),
        jdt.np_from_sortable_unsigned(want, dtype).view(np.uint8))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16], ids=["u16", "i16"])
def test_16bit_to_sortable_matches_jax(dtype):
    """A 16-bit key's image is the JAX package's 16-bit image zero-extended
    into int32, and goes back to the caller's dtype."""
    info = np.iinfo(dtype)
    data = np.random.default_rng(8).integers(info.min, info.max + 1, 2000)
    data = data.astype(dtype)
    data[:2] = (info.min, info.max)
    want = np.asarray(jdt.to_sortable_unsigned(jnp.asarray(data)))
    bits = tdt.to_sortable(tdt.tensor_from_numpy(data, "cpu"))
    assert bits.dtype == tdt.signed_container(dtype) == torch.int32
    np.testing.assert_array_equal(bits.numpy(), want.astype(np.int32))
    back = tdt.tensor_to_numpy(tdt.from_sortable(bits, dtype))
    assert back.dtype == data.dtype
    np.testing.assert_array_equal(back, data)


def test_registry_matches_jax():
    assert tdt.SUPPORTED_KEY_DTYPES == jdt.SUPPORTED_KEY_DTYPES
    for d in jdt.SUPPORTED_KEY_DTYPES:
        assert tdt.type_name(d) == jdt.type_name(d)
        assert tdt.c_name(d) == jdt.c_name(d)
        assert tdt.type_name(tdt.torch_dtype(d)) == jdt.type_name(d)
    with pytest.raises(TypeError):
        tdt.to_sortable(torch.zeros(3, dtype=torch.int8))


def test_sentinel_is_the_max_unsigned_pattern():
    for dtype in ALL_DTYPES:
        bits = torch.tensor([tdt.SENTINEL_BITS],
                            dtype=tdt.signed_container(dtype))
        u = bits.numpy().view(jdt.unsigned_container(dtype))[0]
        assert int(u) == jdt.sentinel_max_unsigned(dtype)


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=IDS)
def test_datasets_byte_identical(dtype):
    for cls_j, cls_t in zip(jds.ALL_DATASETS, tds.ALL_DATASETS):
        assert cls_j.name == cls_t.name
    for dj, dt in zip(jds.make_datasets(dtype, seed=3),
                      tds.make_datasets(dtype, seed=3)):
        a, b = dj.generate(1537), dt.generate(1537)
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), dj.name


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.float32],
                         ids=["u32", "i64", "f32"])
def test_golden_matches_jax(dtype):
    data = jds.RandomDistributed(dtype, seed=9).generate(999)
    np.testing.assert_array_equal(tgold.oracle_argsort(data),
                                  jgold.oracle_argsort(data))
    np.testing.assert_array_equal(tgold.cpu_radix_sort(data).view(np.uint8),
                                  jgold.cpu_radix_sort(data).view(np.uint8))
    s = tgold.oracle_sort(data)
    assert tgold.validate_bit_exact(s, jgold.oracle_sort(data), 999)
    assert not tgold.validate_bit_exact(s[::-1].copy(), s, 999)


def test_sort_config_from_jax_fields():
    jcfg = rst.SortConfig(bits_per_pass=4, block_elems=2048, engine="auto")
    cfg = convert.sort_config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.bits_per_pass == 4 and cfg.radix == 16
    assert cfg.engine == "auto"
    assert cfg.tile_elems == rtt.DEFAULT_CONFIG.tile_elems
    assert cfg.num_passes(np.uint64) == jcfg.num_passes(np.uint64)
    with pytest.raises(ValueError):
        convert.sort_config_from_fields({"no_such_field": 1})


def test_sort_config_keeps_harness_fields_and_renames_engine():
    jcfg = rst.SortConfig(max_input_elems=1 << 20, perf_iterations=3,
                          engine="pallas_merge")
    cfg = convert.sort_config_from_fields(dataclasses.asdict(jcfg))
    assert cfg.engine == "merge"
    assert cfg.max_input_elems == 1 << 20
    assert not hasattr(cfg, "perf_iterations")  # dropped: nothing reads it
    default = convert.sort_config_from_fields(
        dataclasses.asdict(rst.SortConfig()))
    assert default == rtt.DEFAULT_CONFIG
    assert default.max_input_elems == rst.DEFAULT_CONFIG.max_input_elems


@pytest.mark.parametrize("kw", [{"bits_per_pass": 16}, {"tile_elems": 1000},
                                {"threads_per_cta": 64},
                                {"bits_per_pass": 3},
                                {"max_input_elems": 0}])
def test_sort_config_rejects(kw):
    with pytest.raises(ValueError):
        rtt.SortConfig(**kw)


def test_table_from_jax_table_roundtrip():
    rng = np.random.default_rng(5)
    cols = {"u": rng.integers(0, 2**32, 64, dtype=np.uint32),
            "w": rng.integers(0, 2**63, 64, dtype=np.uint64) * 2,
            "f": rng.standard_normal(64).astype(np.float32),
            "i": np.arange(64, dtype=np.int64)}
    jt = JTable.from_numpy(cols)
    jt = JTable(jt.columns, num_rows=40)
    t = convert.table_from_numpy(
        {k: np.asarray(v) for k, v in jt.columns.items()},
        num_rows=np.asarray(jt.num_rows), device="cpu")
    assert t.capacity == 64 and int(t.num_rows) == 40
    assert t.num_rows.dtype == torch.int32 and t.num_rows.ndim == 0
    assert t["u"].dtype == torch.uint32 and t["w"].dtype == torch.uint64
    got, want = t.to_numpy(), jt.to_numpy()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(t.valid_mask().numpy(),
                                  np.asarray(jt.valid_mask()))
    h, jh = t.head(10), jt.head(10)
    assert h.capacity == jh.capacity and int(h.num_rows) == int(jh.num_rows)
    assert t.column_names == jt.column_names


def test_table_column_with_columns_select_match_jax():
    """column, with_columns and select give the JAX Table's columns and
    keep num_rows; select orders nothing (column_names are sorted)."""
    rng = np.random.default_rng(6)
    cols = {"u": rng.integers(0, 2**32, 32, dtype=np.uint64).astype(
                np.uint32),
            "f": rng.standard_normal(32).astype(np.float32),
            "i": np.arange(32, dtype=np.int64)}
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()}, num_rows=20)
    t = Table({k: tdt.tensor_from_numpy(v, "cpu") for k, v in cols.items()},
              num_rows=20)
    assert t.column("u") is t["u"]
    np.testing.assert_array_equal(tdt.tensor_to_numpy(t.column("u")),
                                  np.asarray(jt.column("u")))
    extra = np.arange(32, dtype=np.int32) * 3
    w, jw = (t.with_columns(x=torch.from_numpy(extra), f=t["i"]),
             jt.with_columns(x=jnp.asarray(extra), f=jt["i"]))
    s, js = w.select(["x", "u"]), jw.select(["x", "u"])
    for got, want in ((w, jw), (s.select(("u",)), js.select(("u",))), (s, js)):
        assert got.column_names == want.column_names
        assert int(got.num_rows) == int(want.num_rows) == 20
        assert got.capacity == want.capacity
        g, wn = got.to_numpy(), want.to_numpy()
        for k in wn:
            assert g[k].dtype == wn[k].dtype
            np.testing.assert_array_equal(g[k], wn[k])
    with pytest.raises(KeyError):
        t.select(["nope"])
    assert t.column_names == ("f", "i", "u")  # the original is unchanged


def test_table_with_columns_rejects_bad_columns():
    t = Table({"a": torch.zeros(4)}, num_rows=2)
    with pytest.raises(rtt.EngineError):
        t.with_columns(b=torch.zeros(5))
    with pytest.raises(rtt.EngineError):
        t.with_columns(b=torch.zeros((4, 1)))
    with pytest.raises(rtt.EngineError):  # another device than the table's
        t.with_columns(b=torch.zeros(4, device="meta"))


def test_table_rejects_bad_columns():
    with pytest.raises(rtt.EngineError):
        Table({})
    with pytest.raises(rtt.EngineError):
        Table({"a": torch.zeros(3), "b": torch.zeros(4)})
    with pytest.raises(rtt.EngineError):
        Table({"a": torch.zeros((2, 2))})
    with pytest.raises(rtt.EngineError):
        Table({"a": torch.zeros(3)}).head(-1)


def test_status_codes_match_jax():
    from radix_sort_tpu import status as js
    from radix_sort_tpu_torch import status as ts

    assert [(s.name, s.value) for s in js.OperationStatus] == \
        [(s.name, s.value) for s in ts.OperationStatus]
