"""Filter, aggregate, distinct and join of the port against the JAX
package's, on the same tables carried across with convert.table_from_numpy.

Tables have padding rows (num_rows < capacity) and real keys equal to the
padding sentinel (0xFFFFFFFF for u32): the port sorts on the key alone
where the JAX package sorts on two keys, and those rows test that the
valid-prefix invariant makes the two orders the same.

Float sum/mean are compared with rtol 1e-6 (f32) and 1e-12 (f64): the JAX
aggregate sorts with an unstable network and sums each group with a
segmented scan, so rows of a group may be added in another order.
Everything else is bit-exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radix_sort_tpu.ops import aggregate as jagg, filter as jfilt
from radix_sort_tpu.ops import join as jjoin
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import aggregate, filter as filt, join

SENT32 = np.uint32(0xFFFFFFFF)


def both(cols, num_rows=None):
    """The same numpy columns as a JAX Table and as the port's Table."""
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                num_rows=num_rows)
    tt = convert.table_from_numpy(
        {k: np.asarray(v) for k, v in jt.columns.items()},
        num_rows=np.asarray(jt.num_rows), device="cpu")
    return jt, tt


def jx(fn, *tables):
    """Run a JAX operator under jit: one XLA compile, where eager mode
    compiles every primitive of the segmented scans separately."""
    return jax.jit(fn)(*tables)


def assert_tables_equal(got, want, float_rtol=None):
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        if float_rtol is not None and w[k].dtype.kind == "f":
            np.testing.assert_allclose(g[k], w[k], rtol=float_rtol[w[k].dtype])
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _keys(rng, dtype, n, hi):
    k = rng.integers(0, hi, n).astype(dtype)
    if np.dtype(dtype) == np.uint32:
        k[rng.random(n) < 0.05] = SENT32  # real keys equal to the sentinel
    return k


@pytest.mark.parametrize("op", ["eq", "ne", "lt", "le", "gt", "ge"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.float32],
                         ids=["u32", "i64", "f32"])
def test_filter_expr_matches_jax(op, dtype):
    rng = np.random.default_rng(1)
    n = 1500
    k = _keys(rng, dtype, n, 60)
    x = rng.integers(-5, 5, n).astype(np.int32)
    jt, tt = both({"k": k, "x": x}, num_rows=1400)
    assert_tables_equal(filt.filter_expr(tt, "k", op, 30),
                        jx(lambda t: jfilt.filter_expr(t, "k", op, 30), jt))


def test_filter_unsigned_compares_in_unsigned_order():
    k = np.array([1, 0x80000000, 0xFFFFFFFF, 5], np.uint32)
    jt, tt = both({"k": k})
    for v in (2, 0x80000001):
        assert_tables_equal(filt.filter_expr(tt, "k", "lt", v),
                            jx(lambda t: jfilt.filter_expr(t, "k", "lt", v),
                               jt))


AGG_VALUE_DTYPES = [np.int32, np.int64, np.float32, np.float64]
RTOL = {np.dtype(np.float32): 1e-6, np.dtype(np.float64): 1e-12}


@pytest.mark.parametrize("vdtype", AGG_VALUE_DTYPES,
                         ids=["i32", "i64", "f32", "f64"])
@pytest.mark.parametrize("kdtype", [np.uint32, np.int64, np.float64],
                         ids=["u32", "i64", "f64"])
def test_hash_aggregate_all_ops_match_jax(kdtype, vdtype):
    rng = np.random.default_rng(3)
    n = 2000
    k = _keys(rng, kdtype, n, 50)
    if np.dtype(vdtype).kind == "f":  # positive: sums have no cancellation
        v = rng.random(n).astype(vdtype) * 100
    else:
        v = rng.integers(-1000, 1000, n).astype(vdtype)
    jt, tt = both({"k": k, "v": v}, num_rows=1900)
    aggs = {"n": ("count", None), "s": ("sum", "v"), "lo": ("min", "v"),
            "hi": ("max", "v"), "m": ("mean", "v")}
    assert_tables_equal(aggregate.hash_aggregate(tt, "k", aggs),
                        jx(lambda t: jagg.hash_aggregate(t, "k", aggs), jt),
                        float_rtol=RTOL)


def test_hash_aggregate_int32_sum_wraps_like_jax():
    k = np.array([1, 1, 2, 2], np.uint32)
    v = np.array([2**31 - 1, 5, -2**31, -1], np.int32)
    jt, tt = both({"k": k, "v": v})
    aggs = {"s": ("sum", "v"), "m": ("mean", "v")}
    assert_tables_equal(aggregate.hash_aggregate(tt, "k", aggs),
                        jx(lambda t: jagg.hash_aggregate(t, "k", aggs), jt))


@pytest.mark.parametrize("vdtype", [np.uint32, np.uint64], ids=["u32", "u64"])
def test_hash_aggregate_unsigned_values_and_sentinel_only_group(vdtype):
    rng = np.random.default_rng(4)
    n = 600
    k = np.full(n, SENT32)
    k[:100] = rng.integers(0, 5, 100)
    v = rng.integers(0, np.iinfo(vdtype).max, n, dtype=vdtype)
    jt, tt = both({"k": k, "v": v}, num_rows=500)
    aggs = {"n": ("count", None), "s": ("sum", "v"), "lo": ("min", "v"),
            "hi": ("max", "v"), "m": ("mean", "v")}
    assert_tables_equal(aggregate.hash_aggregate(tt, "k", aggs),
                        jx(lambda t: jagg.hash_aggregate(t, "k", aggs), jt))


def test_hash_aggregate_rejects():
    jt, tt = both({"k": np.arange(4, dtype=np.int32)})
    with pytest.raises(ValueError):
        aggregate.hash_aggregate(tt, "k", {"x": ("median", "k")})
    with pytest.raises(ValueError):
        aggregate.hash_aggregate(tt, "k", {"n": ("count", None)},
                                 method="no_such_method")


def assert_capacity_equal(got, want, float_rtol=None):
    """Every row of the capacity, padding included, and num_rows."""
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    for k, w in want.columns.items():
        g, w = tdt.tensor_to_numpy(got[k]), np.asarray(w)
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        if float_rtol is not None and w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=float_rtol[w.dtype])
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("vdtype", AGG_VALUE_DTYPES,
                         ids=["i32", "i64", "f32", "f64"])
@pytest.mark.parametrize("kdtype", [np.uint32, np.int64, np.float64],
                         ids=["u32", "i64", "f64"])
def test_hash_aggregate_segment_matches_jax(kdtype, vdtype):
    """method="segment" against the JAX package's: every row of the
    capacity, the empty segments' identities and the padding segment
    included; an int32 mean is float32, as there."""
    rng = np.random.default_rng(3)
    n = 2000
    k = _keys(rng, kdtype, n, 50)
    if np.dtype(vdtype).kind == "f":
        v = rng.random(n).astype(vdtype) * 100
    else:
        v = rng.integers(-1000, 1000, n).astype(vdtype)
    jt, tt = both({"k": k, "v": v}, num_rows=1900)
    aggs = {"n": ("count", None), "s": ("sum", "v"), "lo": ("min", "v"),
            "hi": ("max", "v"), "m": ("mean", "v")}
    got = aggregate.hash_aggregate(tt, "k", aggs, method="segment")
    assert_capacity_equal(got, jx(lambda t: jagg.hash_aggregate(
        t, "k", aggs, method="segment"), jt), float_rtol=RTOL)
    # the two methods agree on the groups
    assert_tables_equal(got, aggregate.hash_aggregate(tt, "k", aggs),
                        float_rtol=RTOL)


@pytest.mark.parametrize("vdtype", [np.uint32, np.uint64, np.int16],
                         ids=["u32", "u64", "i16"])
def test_hash_aggregate_segment_unsigned_and_narrow_values(vdtype):
    rng = np.random.default_rng(4)
    n = 600
    k = np.full(n, SENT32)
    k[:100] = rng.integers(0, 5, 100)
    info = np.iinfo(vdtype)
    v = rng.integers(info.min, info.max, n, dtype=vdtype, endpoint=True)
    jt, tt = both({"k": k, "v": v}, num_rows=500)
    aggs = {"n": ("count", None), "s": ("sum", "v"), "lo": ("min", "v"),
            "hi": ("max", "v"), "m": ("mean", "v")}
    assert_capacity_equal(
        aggregate.hash_aggregate(tt, "k", aggs, method="segment"),
        jx(lambda t: jagg.hash_aggregate(t, "k", aggs, method="segment"),
           jt), float_rtol=RTOL)


@pytest.mark.parametrize("num_rows", [None, 700])
def test_distinct_matches_jax(num_rows):
    rng = np.random.default_rng(5)
    n = 900
    k = _keys(rng, np.uint32, n, 40)
    jt, tt = both({"k": k, "row": np.arange(n, dtype=np.int32),
                   "w": rng.standard_normal(n)}, num_rows=num_rows)
    assert_tables_equal(aggregate.distinct(tt, "k"),
                        jx(lambda t: jagg.distinct(t, "k"), jt))


def _join_tables(rng, n_probe, n_build, space, dup):
    pk = _keys(rng, np.uint32, n_probe, space)
    bk = np.repeat(rng.permutation(space)[:n_build // dup], dup)
    bk = rng.permutation(bk).astype(np.uint32)
    bk[:dup] = SENT32  # a run of sentinel-valued build keys
    probe = {"k": pk, "pv": np.arange(n_probe, dtype=np.int32)}
    build = {"k": bk, "bv": (bk * 3).astype(np.int32),
             "bw": rng.standard_normal(bk.size)}
    return probe, build


@pytest.mark.parametrize("max_dup", [1, 3])
def test_hash_join_matches_jax(max_dup):
    rng = np.random.default_rng(6 + max_dup)
    probe, build = _join_tables(rng, 1200, 300, 500, max_dup)
    jp, tp = both(probe, num_rows=1100)
    jb, tb = both(build, num_rows=290)
    jres, jstats = jx(lambda p, b: jjoin.hash_join(
        p, b, "k", max_duplicates=max_dup), jp, jb)
    tres, tstats = join.hash_join(tp, tb, "k", max_duplicates=max_dup)
    assert int(tstats["match_count"]) == int(jstats["match_count"])
    assert not bool(jstats["overflow"])
    assert not bool(tstats["overflow"])
    assert_tables_equal(tres, jres)


@pytest.mark.parametrize("case", ["duplicates", "capacity"])
def test_hash_join_overflow_matches_jax(case):
    rng = np.random.default_rng(9)
    probe, build = _join_tables(rng, 800, 240, 300, 3)
    jp, tp = both(probe)
    jb, tb = both(build)
    kw = ({"max_duplicates": 2} if case == "duplicates"
          else {"max_duplicates": 3, "out_capacity": 50})
    jres, jstats = jx(lambda p, b: jjoin.hash_join(p, b, "k", **kw), jp, jb)
    tres, tstats = join.hash_join(tp, tb, "k", **kw)
    assert bool(jstats["overflow"]) and bool(tstats["overflow"])
    assert int(tstats["match_count"]) == int(jstats["match_count"])
    assert_tables_equal(tres, jres)


def test_hash_join_key_dtype_mismatch_raises():
    _, a = both({"k": np.arange(3, dtype=np.int32)})
    _, b = both({"k": np.arange(3, dtype=np.int64)})
    with pytest.raises(ValueError):
        join.hash_join(a, b, "k")
