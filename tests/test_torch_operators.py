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
import torch

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


def _valid_bits_equal(got, want):
    """Names, dtypes, capacity, num_rows, and every valid row bit for bit
    (NaN payloads and signs included)."""
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        u = np.dtype(f"u{w[k].dtype.itemsize}")
        np.testing.assert_array_equal(g[k].view(u), w[k].view(u), err_msg=k)


I64_MAX = np.iinfo(np.int64).max  # its sortable image is the sentinel


def _edge_tables(case, rng):
    """(probe, probe num_rows, build, build num_rows, hash_join kwargs)."""
    kw = {}
    if case in ("sentinel_u32", "sentinel_i64"):
        dt, sent = ((np.uint32, SENT32) if case == "sentinel_u32"
                    else (np.int64, I64_MAX))
        pk = rng.integers(0, 60, 400).astype(dt)
        pk[rng.random(400) < 0.1] = sent
        bk = rng.permutation(np.arange(59, dtype=dt))[:50]
        bk[7] = sent
        return ({"k": pk, "pv": np.arange(400, dtype=np.int32)}, 370,
                {"k": bk, "bv": (np.arange(50) * 7).astype(np.int64)}, 45,
                kw)
    pk = rng.integers(0, 40, 300).astype(np.int64)
    pk[::17] = I64_MAX  # meets the build's padding in the sentinel run
    probe = {"k": pk, "pv": np.arange(300, dtype=np.int32),
             "px": rng.standard_normal(300)}
    bk = rng.permutation(40).astype(np.int64)
    build = {"k": bk, "bd": rng.integers(0, 9999, 40).astype(np.int32),
             "bw": rng.standard_normal(40)}
    p_rows, b_rows = 280, 38
    if case == "empty_probe":
        probe = {c: v[:0] for c, v in probe.items()}
        p_rows = 0
    elif case == "empty_build":
        build = {c: v[:0] for c, v in build.items()}
        b_rows = 0
    elif case == "build_all_padding":
        b_rows = 0
    elif case == "dup3_overflow":
        build = {c: np.concatenate([v, v[:20], v[:10]])
                 for c, v in build.items()}
        b_rows = None
        kw = {"max_duplicates": 3, "out_capacity": 200}
    elif case == "nan_payloads":
        # quiet NaNs with payloads and both signs (the JAX fill keeps
        # these; it quiets a signaling NaN and maps -0.0 to +0.0)
        bits = build["bw"].view(np.uint64).copy()
        bits[:12] = np.array([0x7FF8000000000123, 0xFFF8000000000456,
                              0x7FFFFFFFFFFFFFFF, 0xFFF0000000000000,
                              0x7FF0000000000000, 0x7FF8000000000000] * 2,
                             np.uint64)
        build["bw"] = bits.view(np.float64)
    return probe, p_rows, build, b_rows, kw


EDGE_CASES = ["sentinel_u32", "sentinel_i64", "empty_probe", "empty_build",
              "build_all_padding", "dup3_overflow", "nan_payloads"]


@pytest.mark.parametrize("case", EDGE_CASES)
def test_hash_join_edge_cases_match_jax(case):
    """The join's edges against the JAX package, bit for bit on the valid
    rows: real keys equal to the sentinel on both sides beside padding
    rows (u32, i64), an empty probe, an empty build, a build of padding
    only, three duplicates a key into too small an output, and float64
    build columns of NaN payloads."""
    rng = np.random.default_rng(EDGE_CASES.index(case) + 20)
    probe, p_rows, build, b_rows, kw = _edge_tables(case, rng)
    jp, tp = both(probe, num_rows=p_rows)
    jb, tb = both(build, num_rows=b_rows)
    jres, jstats = jx(lambda p, b: jjoin.hash_join(p, b, "k", **kw), jp, jb)
    tres, tstats = join.hash_join(tp, tb, "k", **kw)
    assert int(tstats["match_count"]) == int(jstats["match_count"])
    assert bool(tstats["overflow"]) == bool(jstats["overflow"])
    assert bool(tstats["overflow"]) == (case == "dup3_overflow")
    matches = int(tstats["match_count"])
    assert (matches == 0) == case.startswith(("empty", "build_all"))
    _valid_bits_equal(tres, jres)


def test_hash_join_sorts_key_and_one_row_id(monkeypatch):
    """A Q3-shaped join (int64 key, three columns a side): the join's sort
    takes the padded key and one int32 row-id plane of P + B rows, its
    compaction two int32 id planes, and ``join.sorted_bytes`` grows by
    12 (P + B)."""
    from radix_sort_tpu_torch.ops import partition, sort as sort_ops

    sorts, compacts = [], []
    real_sort, real_compact = sort_ops.sort_biased_kv, partition.compact_mask

    def sort_biased_kv(keys, payloads, *a, **k):
        sorts.append((keys, tuple(payloads)))
        return real_sort(keys, payloads, *a, **k)

    def compact_mask(mask, arrays, *a, **k):
        compacts.append(tuple(arrays))
        return real_compact(mask, arrays, *a, **k)

    monkeypatch.setattr(sort_ops, "sort_biased_kv", sort_biased_kv)
    monkeypatch.setattr(partition, "compact_mask", compact_mask)
    rng = np.random.default_rng(31)
    P, B = 900, 300
    okey = rng.permutation(np.arange(1, 4 * B, 4))[:B].astype(np.int64)
    lkey = okey[rng.integers(0, B, P)]
    lkey[::5] += 2  # line items of no order
    probe = {"k": lkey, "price": rng.integers(1, 10**7, P).astype(np.int64),
             "disc": rng.standard_normal(P)}
    build = {"k": okey, "date": rng.integers(8000, 11000, B).astype(np.int32),
             "prio": rng.integers(0, 5, B).astype(np.int32)}
    jp, tp = both(probe, num_rows=850)
    jb, tb = both(build, num_rows=290)
    before = join.sorted_bytes
    tres, tstats = join.hash_join(tp, tb, "k")
    assert join.sorted_bytes - before == 12 * (P + B)
    (keys, payloads), = sorts
    assert keys.dtype == torch.int64 and keys.shape == (P + B,)
    assert [(p.dtype, tuple(p.shape)) for p in payloads] == [
        (torch.int32, (P + B,))]
    (planes,) = compacts
    assert [p.dtype for p in planes] == [torch.int32, torch.int32]
    jres, jstats = jx(lambda p, b: jjoin.hash_join(p, b, "k"), jp, jb)
    assert int(tstats["match_count"]) == int(jstats["match_count"]) > 0
    _valid_bits_equal(tres, jres)


def test_hash_join_key_dtype_mismatch_raises():
    _, a = both({"k": np.arange(3, dtype=np.int32)})
    _, b = both({"k": np.arange(3, dtype=np.int64)})
    with pytest.raises(ValueError):
        join.hash_join(a, b, "k")


# ---- float min/max: selections with the JAX package's NaN and zero rules --

def _float_groups(dtype):
    """(keys, values, expected min, expected max) of groups [NaN, 1.0],
    [-0.0, 0.0], [0.0, -0.0], [NaN], [NaN with a payload, 2.0],
    [1.0, that NaN], [-inf, inf] and [-NaN, 5.0]: each expected result is
    one of the group's values, bits included (what ``jnp.minimum`` /
    ``jnp.maximum`` select on the CPU)."""
    d = np.dtype(dtype)
    u = np.dtype(f"u{d.itemsize}")
    q = np.array([np.nan], d)
    pay = (q.view(u) | u.type(5)).view(d)[0]
    neg = (q.view(u) | u.type(1 << (8 * d.itemsize - 1))).view(d)[0]
    q = q[0]
    groups = [([q, 1.0], q, q), ([-0.0, 0.0], -0.0, 0.0),
              ([0.0, -0.0], -0.0, 0.0), ([q], q, q), ([pay, 2.0], pay, pay),
              ([1.0, pay], pay, pay), ([-np.inf, np.inf], -np.inf, np.inf),
              ([neg, 5.0], neg, neg)]
    keys = np.concatenate([[i] * len(g) for i, (g, _, _) in
                           enumerate(groups)]).astype(np.uint32)
    vals = np.concatenate([np.array(g, d) for g, _, _ in groups])
    lo = np.array([x for _, x, _ in groups], d)
    hi = np.array([x for _, _, x in groups], d)
    return keys, vals, lo, hi


def _bits(x):
    x = np.asarray(x)
    return x.view(f"u{x.dtype.itemsize}")


@pytest.mark.parametrize("method", ["scan", "segment"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_float_min_max_select_jax_bits(dtype, method):
    """min/max over NaN, +-0.0 and +-inf keep the input's bits under both
    methods: the quiet NaN 0x7fc00000 (not torch's all-ones NaN), a NaN's
    payload and sign, +0.0 for max(-0.0, +0.0) and -0.0 for the min.  The
    JAX package gives the same bits, with one exception stated here: its
    scan method moves values through ``jax.lax.associative_scan``, whose
    interleave adds zero padding, so its min of a group of zeros is +0.0;
    its segment method gives -0.0, as the port's two methods do."""
    keys, vals, lo, hi = _float_groups(dtype)
    jt, tt = both({"k": keys, "v": vals})
    aggs = {"lo": ("min", "v"), "hi": ("max", "v")}
    got = aggregate.hash_aggregate(tt, "k", aggs, method=method).to_numpy()
    want = jx(lambda t: jagg.hash_aggregate(t, "k", aggs, method=method),
              jt).to_numpy()
    np.testing.assert_array_equal(_bits(got["lo"]), _bits(lo))
    np.testing.assert_array_equal(_bits(got["hi"]), _bits(hi))
    jax_lo = lo.copy()
    if method == "scan":
        jax_lo[jax_lo == 0] = 0  # -0.0 -> +0.0 through the JAX scan
    np.testing.assert_array_equal(_bits(want["lo"]), _bits(jax_lo))
    np.testing.assert_array_equal(_bits(want["hi"]), _bits(hi))
    if dtype == np.float32:
        assert _bits(got["lo"])[0] == 0x7FC00000


@pytest.mark.parametrize("method", ["scan", "segment"])
def test_nan_computed_by_sum_and_mean_may_differ_in_sign(method):
    """The deliberate exception to bit parity: a NaN that ``sum`` or
    ``mean`` computes (here inf + -inf) is arithmetic, not a selection,
    and its bits are the platform's default NaN, whose sign bit the two
    packages need not share.  Both must give a NaN."""
    keys = np.array([0, 0, 1, 1], np.uint32)
    vals = np.array([np.inf, -np.inf, 1.0, 2.0], np.float32)
    jt, tt = both({"k": keys, "v": vals})
    aggs = {"s": ("sum", "v"), "m": ("mean", "v")}
    got = aggregate.hash_aggregate(tt, "k", aggs, method=method).to_numpy()
    want = jx(lambda t: jagg.hash_aggregate(t, "k", aggs, method=method),
              jt).to_numpy()
    for k in aggs:
        assert np.isnan(got[k][0]) and np.isnan(want[k][0])
        np.testing.assert_array_equal(got[k][1:], want[k][1:])
