"""Window functions, the segmented scan and the segmented sort of the port
against the JAX package's.

Every case of ``tests/test_window.py`` feeds the same numpy inputs (from a
seed) to both packages; the JAX side runs under ``jax.jit`` (eager mode
compiles each primitive of its segmented scans).  Integer outputs must be
equal bit for bit on every row, masked rows included.  Float running sums
are compared with rtol 1e-5 (f32) and 1e-12 (f64): the port's doubling scan
and the JAX ``associative_scan`` add a partition's rows in another order;
every other float output is exact.  The cases marked ``cuda`` hold the
window, ``Query.sort_by`` and the segment aggregate on the card against
their CPU results."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radix_sort_tpu.ops import aggregate as jagg, window as jwin
from radix_sort_tpu.query import Query as JQuery
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import Query, SortConfig, dtypes as tdt
from radix_sort_tpu_torch.ops import aggregate, cuda_radix, window as win
from radix_sort_tpu_torch.status import EngineError
from radix_sort_tpu_torch.table import Table

RTOL = {np.dtype(np.float32): 1e-5, np.dtype(np.float64): 1e-12}
ALL_KINDS = {"rn": ("row_number",), "rk": ("rank",), "dr": ("dense_rank",),
             "cc": ("cum_count",), "s": ("cum_sum", "v"),
             "mn": ("cum_min", "v"), "mx": ("cum_max", "v"),
             "fv": ("first_value", "v"), "lg": ("lag", "v", 1, 7),
             "ld": ("lead", "v", 3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(a, device="cpu"):
    return tdt.tensor_from_numpy(np.asarray(a), device)


def _np(d):
    return {k: tdt.tensor_to_numpy(v) for k, v in d.items()}


def jwindow(part, order, specs, columns=None, valid=None):
    cols = {k: jnp.asarray(v) for k, v in (columns or {}).items()}
    v = None if valid is None else jnp.asarray(valid)
    fn = jax.jit(lambda p, o, c, m: jwin.window(p, o, specs, c, valid=m))
    out = fn(jnp.asarray(part), jnp.asarray(order), cols, v)
    return {k: np.asarray(x) for k, x in out.items()}


def twindow(part, order, specs, columns=None, valid=None, device="cpu",
            config=SortConfig()):
    out = win.window(_t(part, device), _t(order, device), specs,
                     {k: _t(v, device) for k, v in (columns or {}).items()},
                     valid=None if valid is None else _t(valid, device),
                     config=config)
    return _np(out)


def assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        if k in ("s",) and want[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k],
                                       rtol=RTOL[want[k].dtype], err_msg=k)
        else:
            np.testing.assert_array_equal(got[k].view(np.uint8),
                                          want[k].view(np.uint8), err_msg=k)


def both(part, order, specs, columns=None, valid=None):
    assert_same(twindow(part, order, specs, columns, valid),
                jwindow(part, order, specs, columns, valid))


def _data(n=257, nparts=7, seed=0, dtype=np.int32):
    rng = np.random.default_rng(seed)
    part = rng.integers(0, nparts, n).astype(dtype)
    order = rng.integers(0, 13, n).astype(np.int32)  # heavy ties
    vals = rng.integers(-50, 50, n).astype(np.int32)
    return part, order, vals


# ---------------------------------------------------------------------------
# window(), the cases of tests/test_window.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pdtype", [np.int32, np.uint32, np.float32])
def test_row_number_rank_dense_match_jax(pdtype):
    part, order, _ = _data(dtype=np.int32)
    both(part.astype(pdtype), order,
         {"rn": ("row_number",), "rk": ("rank",), "dr": ("dense_rank",),
          "cc": ("cum_count",)})


def test_cumulative_aggregates_match_jax():
    part, order, vals = _data(seed=3)
    both(part, order, {"s": ("cum_sum", "v"), "mn": ("cum_min", "v"),
                       "mx": ("cum_max", "v"), "fv": ("first_value", "v")},
         {"v": vals})


@pytest.mark.parametrize("k", [1, 2, 5, 400])
def test_lag_lead_match_jax(k):
    part, order, vals = _data(seed=4)
    both(part, order, {"lg": ("lag", "v", k, -999),
                       "ld": ("lead", "v", k, -999)}, {"v": vals})


def test_tie_heavy_single_partition_matches_jax():
    n = 200
    z = np.zeros(n, np.int32)
    got = twindow(z, z, {"rn": ("row_number",), "rk": ("rank",),
                         "dr": ("dense_rank",)})
    np.testing.assert_array_equal(got["rn"], np.arange(1, n + 1))
    np.testing.assert_array_equal(got["rk"], np.ones(n))
    assert_same(got, jwindow(z, z, {"rn": ("row_number",), "rk": ("rank",),
                                    "dr": ("dense_rank",)}))


def test_row_number_and_cum_sum_match_jax():
    """The JAX test's jit case: the port has no jit; same outputs."""
    part, order, vals = _data(seed=5)
    both(part, order, {"rn": ("row_number",), "s": ("cum_sum", "v")},
         {"v": vals})


def test_window_empty():
    z = torch.zeros(0, dtype=torch.int32)
    out = win.window(z, z, {"rn": ("row_number",), "s": ("cum_sum", "v")},
                     columns={"v": z.to(torch.float32)})
    assert out["rn"].shape == (0,) and out["rn"].dtype == torch.int32
    assert out["s"].shape == (0,) and out["s"].dtype == torch.float32


def test_window_spec_errors():
    p = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("row_number", "extra")})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("nope",)})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("lag", "v", 0)}, columns={"v": p})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("cum_sum", "missing")})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("cum_sum", "v")}, columns={"v": p[:3]})
    with pytest.raises(EngineError):
        win.window(p, p, {"x": ("cum_min",)})


def _tables(cols, num_rows):
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                num_rows=num_rows)
    tt = Table({k: _t(v) for k, v in cols.items()}, num_rows=num_rows)
    return jt, tt


def _assert_tables_same(got, want):
    """Every column over the whole capacity, and num_rows."""
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    assert_same({k: tdt.tensor_to_numpy(v) for k, v in got.columns.items()},
                {k: np.asarray(v) for k, v in want.columns.items()})


def test_table_window_padding_isolated_matches_jax():
    # tail garbage shares partition value 1 AND sorts before real rows'
    # order values: it must not perturb any valid row's rank
    part = np.array([1, 2, 1, 2, 1, 1, 1, 1], np.int32)
    order = np.array([5, 1, 3, 2, 4, 0, 0, 0], np.int32)
    vals = np.arange(8, dtype=np.int32)
    jt, tt = _tables({"p": part, "o": order, "v": vals}, 5)
    specs = {"rn": ("row_number",), "s": ("cum_sum", "v")}
    got = win.table_window(tt, "p", "o", specs)
    _assert_tables_same(got, jax.jit(
        lambda t: jwin.table_window(t, "p", "o", specs))(jt))
    np.testing.assert_array_equal(got.to_numpy()["rn"], [3, 1, 1, 2, 2])


def test_query_window_chain_matches_jax():
    part, order, vals = _data(n=100, seed=7)
    jt, tt = _tables({"p": part, "o": order, "v": vals}, 100)

    def q(query):
        return (query.window("p", "o", rn=("row_number",), s=("cum_sum", "v"))
                .filter("rn", "le", 2).collect())

    got = q(Query(tt))
    want = jax.jit(lambda t: q(JQuery(t)))(jt)
    assert int(got.num_rows) == int(want.num_rows)
    g, w = got.to_numpy(), want.to_numpy()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# ---------------------------------------------------------------------------
# what the JAX tests do not pin
# ---------------------------------------------------------------------------

def test_valid_mask_not_a_prefix_matches_jax():
    """Masked rows anywhere (not a padding tail) form trailing partitions
    of their own: every output of every row equals the JAX package's."""
    part, order, vals = _data(n=301, seed=8)
    valid = np.random.default_rng(9).random(301) < 0.6
    both(part, order, ALL_KINDS, {"v": vals}, valid)


def test_all_masked_and_none_masked_match_jax():
    part, order, vals = _data(n=64, seed=10)
    for valid in (np.zeros(64, bool), np.ones(64, bool)):
        both(part, order, ALL_KINDS, {"v": vals}, valid)


def test_signed_zero_partitions_are_distinct():
    """Boundaries compare sortable bits: -0.0 and +0.0 are two partitions
    (and two tie runs of the order key), in both packages."""
    part = np.array([0.0, -0.0, 0.0, -0.0, 1.5, -0.0], np.float32)
    order = np.array([1, 1, 0, 0, 2, 2], np.float32) * np.float32(0.0)
    order[[1, 4]] = -0.0
    got = twindow(part, order, {"rn": ("row_number",), "rk": ("rank",),
                                "dr": ("dense_rank",)})
    # -0.0 rows 1, 3, 5: row 1's order is -0.0 and sorts first
    np.testing.assert_array_equal(got["rn"], [1, 1, 2, 2, 1, 3])
    np.testing.assert_array_equal(got["dr"], [1, 1, 1, 2, 1, 2])
    assert_same(got, jwindow(part, order, {"rn": ("row_number",),
                                           "rk": ("rank",),
                                           "dr": ("dense_rank",)}))


@pytest.mark.parametrize("pdtype", [np.int16, np.uint16], ids=["i16", "u16"])
def test_16bit_partition_key_matches_jax(pdtype):
    rng = np.random.default_rng(12)
    info = np.iinfo(pdtype)
    part = rng.choice(np.array([info.min, 0, 7, info.max], pdtype), 400)
    order = rng.integers(-3, 3, 400).astype(np.int16)
    vals = rng.integers(-50, 50, 400).astype(np.int32)
    valid = rng.random(400) < 0.9
    both(part, order, ALL_KINDS, {"v": vals}, valid)


@pytest.mark.parametrize("vdtype", [np.float32, np.float64, np.uint32,
                                    np.int64, np.int16],
                         ids=["f32", "f64", "u32", "i64", "i16"])
def test_every_kind_over_value_dtypes_matches_jax(vdtype):
    """Float running sums at the stated tolerance; integer sums wrap in the
    column's width (u32 and i16 values near their extremes)."""
    rng = np.random.default_rng(13)
    n = 500
    part = rng.integers(0, 9, n).astype(np.int64)
    order = rng.standard_normal(n).astype(np.float32)
    order[::5] = order[1::5]  # ties
    d = np.dtype(vdtype)
    if d.kind == "f":  # positive: the sums have no cancellation
        vals = (rng.random(n) * 100).astype(d)
    else:
        info = np.iinfo(d)
        vals = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    both(part, order, ALL_KINDS, {"v": vals}, rng.random(n) < 0.8)


def test_torch_sort_engine_gives_the_same_windows():
    part, order, vals = _data(n=300, seed=14)
    valid = np.random.default_rng(15).random(300) < 0.7
    a = twindow(part, order, ALL_KINDS, {"v": vals}, valid)
    b = twindow(part, order, ALL_KINDS, {"v": vals}, valid,
                config=SortConfig(engine="torch_sort"))
    assert_same(a, b)


SCAN_OPS = {"add": jnp.add, "min": jnp.minimum, "max": jnp.maximum,
            "first": lambda a, b: a}


@pytest.mark.parametrize("op", list(SCAN_OPS))
@pytest.mark.parametrize("vdtype", [np.int32, np.uint32, np.int64, np.uint64,
                                    np.float32, np.int16],
                         ids=["i32", "u32", "i64", "u64", "f32", "i16"])
def test_segmented_scan_matches_jax(vdtype, op):
    """n = 3001: three blocks of the two-level doubling scan and a ragged
    tail; runs of ~20 rows and one run across every block boundary."""
    rng = np.random.default_rng(16)
    n = 3001
    d = np.dtype(vdtype)
    if d.kind == "f":
        vals = rng.standard_normal(n).astype(d) * 10
    else:
        info = np.iinfo(d)
        vals = rng.integers(info.min, info.max, n, dtype=d, endpoint=True)
    is_new = rng.random(n) < 0.05
    is_new[0] = False  # row 0 starts a run anyway
    is_new[900:2900] = False  # one run across the block boundaries
    want = np.asarray(jax.jit(lambda v, m: jagg._segmented_scan(
        v, m, SCAN_OPS[op]))(jnp.asarray(vals), jnp.asarray(is_new)))
    got = tdt.tensor_to_numpy(aggregate._segmented_scan(
        _t(vals), torch.from_numpy(is_new), op))
    assert got.dtype == want.dtype
    if d.kind == "f" and op == "add":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.3, 0.02, 0.001, 0.0])
@pytest.mark.parametrize("op", ["add", "min", "max"])
def test_two_level_doubling_scan_matches_one_level(op, density,
                                                   monkeypatch):
    """Small blocks (8 rows), so runs cross many blocks and the scan over
    the blocks' last values takes several steps: equal to the one-level
    doubling scan over the whole array, for every run layout."""
    rng = np.random.default_rng(17)
    n = 1999
    v = torch.from_numpy(rng.integers(-1000, 1000, n).astype(np.int64))
    is_new = torch.from_numpy(rng.random(n) < density)
    _, pos = aggregate.run_starts(is_new)
    fn = aggregate._COMBINE[op]
    want = aggregate._doubling_steps(v, pos, fn)
    for block in (8, 64, 1999, 4096):
        monkeypatch.setattr(aggregate, "SCAN_BLOCK", block)
        got = aggregate._doubling_scan(v, pos, fn)
        assert torch.equal(got, want), block


# ---------------------------------------------------------------------------
# segmented sort
# ---------------------------------------------------------------------------

def test_segmented_sort_matches_jax():
    rng = np.random.default_rng(11)
    bounds = np.sort(rng.choice(np.arange(1, 500), 9, replace=False))
    seg = np.searchsorted(bounds, np.arange(500), side="right").astype(
        np.int32)
    keys = rng.integers(-1000, 1000, 500).astype(np.int32)
    got = win.segmented_sort(_t(seg), _t(keys)).numpy()
    want = np.asarray(jax.jit(jwin.segmented_sort)(jnp.asarray(seg),
                                                   jnp.asarray(keys)))
    np.testing.assert_array_equal(got, want)
    for s in np.unique(seg):
        np.testing.assert_array_equal(got[seg == s], np.sort(keys[seg == s]))


def test_segmented_sort_kv_stable_matches_jax():
    seg = np.repeat(np.arange(4, dtype=np.int32), 16)
    keys = np.tile(np.array([3, 1, 3, 1], np.int32), 16)
    payload = {"row": np.arange(64, dtype=np.int32),
               "u": np.arange(64, dtype=np.uint64) << np.uint64(40)}
    ks, vs = win.segmented_sort_kv(_t(seg), _t(keys),
                                   {k: _t(v) for k, v in payload.items()})
    jk, jv = jax.jit(jwin.segmented_sort_kv)(
        jnp.asarray(seg), jnp.asarray(keys),
        {k: jnp.asarray(v) for k, v in payload.items()})
    np.testing.assert_array_equal(ks.numpy(), np.asarray(jk))
    for k in payload:
        got = tdt.tensor_to_numpy(vs[k])
        assert got.dtype == payload[k].dtype
        np.testing.assert_array_equal(got, np.asarray(jv[k]))
    np.testing.assert_array_equal(
        vs["row"].numpy(), np.lexsort((np.arange(64), keys, seg)))


def test_segmented_sort_float_keys_matches_jax():
    seg = np.repeat(np.arange(2, dtype=np.int32), 8)
    keys = np.array([1.5, -np.inf, np.inf, -0.0, 0.0, 2.0, -3.5, 1.5,
                     9.0, -9.0, 0.5, 0.25, -0.25, 7.0, -7.0, 3.0],
                    np.float32)
    got = win.segmented_sort(_t(seg), _t(keys)).numpy()
    want = np.asarray(jax.jit(jwin.segmented_sort)(jnp.asarray(seg),
                                                   jnp.asarray(keys)))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_segmented_sort_length_mismatch():
    with pytest.raises(EngineError):
        win.segmented_sort(torch.zeros(3, dtype=torch.int32),
                           torch.zeros(4, dtype=torch.int32))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _big(n, seed=20):
    rng = np.random.default_rng(seed)
    return {"p": rng.integers(0, 1 << 12, n).astype(np.int32),
            "o": rng.integers(0, 1 << 16, n).astype(np.int32),
            "v": rng.integers(-50, 50, n).astype(np.int32),
            "f": rng.random(n).astype(np.float32)}


def _launched(fn):
    cuda_radix.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = cuda_radix.launch_counts()
    assert counts["pass_histograms"] > 0 and counts["onesweep_pass"] > 0, \
        counts
    return out


def _table_np(t):
    return {k: tdt.tensor_to_numpy(v) for k, v in t.columns.items()}


@pytest.mark.cuda
def test_cuda_window_matches_cpu(cuda_device):
    """Query.window at 2^20 with every kind on the card equals the CPU run
    on every row, and launched the radix kernels."""
    n = 1 << 20
    cols = _big(n)
    specs = dict(ALL_KINDS, fs=("cum_sum", "f"), fm=("cum_max", "f"))

    def run(dev):
        t = Table({k: _t(v, dev) for k, v in cols.items()},
                  num_rows=n - 4099)
        return Query(t).window("p", "o", **specs).collect()

    got = _table_np(_launched(lambda: run(cuda_device)))
    want = _table_np(run("cpu"))
    for k in want:
        if k == "fs":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_cuda_sort_by_matches_cpu(cuda_device):
    n = 1 << 20
    rng = np.random.default_rng(21)
    cols = {"a": rng.integers(0, 64, n).astype(np.uint32),
            "b": rng.integers(-2**15, 2**15, n).astype(np.int16),
            "c": rng.standard_normal(n).astype(np.float32),
            "row": np.arange(n, dtype=np.int32)}

    def run(dev):
        t = Table({k: _t(v, dev) for k, v in cols.items()}, num_rows=n - 77)
        return Query(t).sort_by("a", "b", "c",
                                descending=[False, True, False]).collect()

    got = _table_np(_launched(lambda: run(cuda_device)))
    want = _table_np(run("cpu"))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    m = n - 77
    order = np.lexsort((cols["c"][:m], -cols["b"][:m].astype(np.int32),
                        cols["a"][:m]))
    np.testing.assert_array_equal(got["row"][:m], order)


@pytest.mark.cuda
def test_cuda_segment_aggregate_matches_cpu(cuda_device):
    n = 1 << 20
    rng = np.random.default_rng(22)
    cols = {"k": rng.integers(0, 5000, n).astype(np.uint32),
            "x": rng.integers(-100, 100, n).astype(np.int32),
            "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
            "f": rng.random(n).astype(np.float32)}
    aggs = {"n": ("count", None), "s": ("sum", "x"), "lo": ("min", "u"),
            "hi": ("max", "x"), "m": ("mean", "x"), "fs": ("sum", "f")}

    def run(dev):
        t = Table({k: _t(v, dev) for k, v in cols.items()}, num_rows=n - 5)
        return aggregate.hash_aggregate(t, "k", aggs, method="segment")

    got = _table_np(_launched(lambda: run(cuda_device)))
    want = _table_np(run("cpu"))
    for k in want:
        if k == "fs":  # atomic adds on the card: another order
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
