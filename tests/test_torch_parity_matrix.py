"""Parity matrix: every key dtype the JAX package accepts x every public
entry point of the port that takes a key or a float column.

The dtypes are those ``radix_sort_tpu.dtypes.to_sortable_unsigned``
accepts by kind and width: u8, i8, u16, i16, u32, i32, u64, i64, f16, f32
and f64.  Each case makes its inputs with numpy from a seed at one n, with
the dtype's extremes planted (and, for floats, NaN, -0.0, +0.0, +-inf and
subnormals), runs them through the JAX function (operators under
``jax.jit``) and through the port's on the CPU, and compares the outputs
through ``.view(np.uint8)``: a bare ``assert_array_equal`` counts any NaN
equal to any NaN and -0.0 equal to +0.0.

Value columns for min/max, first_value and lag/lead hold the specials too,
with one NaN pattern (the quiet NaN): the JAX aggregate sorts with an
unstable network, so a group holding two different NaNs has no defined
answer.  Sums and means run over a column of small integers, which every
dtype adds exactly in any order.  ``bool`` and ``bfloat16`` keys raise
``TypeError`` in both packages.

Float min/max, first_value and the join's build columns are selections in
the port: each result is one of the inputs, bits included.  Two effects of
the JAX package's arithmetic on the CPU are stated, not copied, and the
comparison maps the port's selections through them (``_scan_image``,
``_ftz``): ``jax.lax.associative_scan`` joins its levels by padding with
zeros and adding, so every float that a JAX scan moves (the scan
aggregate's min/max, cum_min, cum_max, first_value, the join's fill of
build columns) comes out with -0.0 as +0.0 and a signaling NaN quieted;
and XLA's CPU code flushes float32/float64 subnormals to zero in min/max
and in those additions.  The port's two aggregate methods give the same
bits, which are those of the JAX segment method wherever no subnormal is
selected.

The cases marked ``cuda`` run the port at 2^20 rows on the card against
its own CPU result, and count the radix passes through
``cuda_radix.launch_counts()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu import datasets_device as jdd, io as jio
from radix_sort_tpu.ops import aggregate as jagg, filter as jfilt
from radix_sort_tpu.ops import join as jjoin
from radix_sort_tpu.ops import topk as jtopk, window as jwin
from radix_sort_tpu.query import Query as JQuery
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu.ops import partition as jpart
from radix_sort_tpu_torch import Query, datasets_device as dd
from radix_sort_tpu_torch import dtypes as tdt, golden, io as tio
from radix_sort_tpu_torch.ops import aggregate, chunked_sort, partition
from radix_sort_tpu_torch.ops import cuda_radix as cr, filter as filt, join
from radix_sort_tpu_torch.ops import topk, window as win
from radix_sort_tpu_torch.table import Table

DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.uint64, np.int64, np.float16, np.float32, np.float64]
IDS = ["u8", "i8", "u16", "i16", "u32", "i32", "u64", "i64", "f16", "f32",
       "f64"]
N = 1001
NUM_ROWS = 950  # tables carry padding rows past num_rows
AGGS = {"n": ("count", None), "s": ("sum", "w"), "lo": ("min", "v"),
        "hi": ("max", "v"), "m": ("mean", "w")}
WINDOW_KINDS = {"rn": ("row_number",), "rk": ("rank",),
                "dr": ("dense_rank",), "cc": ("cum_count",),
                "s": ("cum_sum", "w"), "mn": ("cum_min", "v"),
                "mx": ("cum_max", "v"), "fv": ("first_value", "v"),
                "lg": ("lag", "v", 1, 7), "ld": ("lead", "v", 3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# ---- inputs ---------------------------------------------------------------

def _specials(d: np.dtype) -> np.ndarray:
    if d.kind == "f":
        fi = np.finfo(d)
        sub = fi.smallest_subnormal
        return np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, sub, -sub,
                         fi.max, -fi.max, fi.tiny, 1.0, -1.0], d)
    ii = np.iinfo(d)
    return np.array([ii.min, ii.max, 0, 1, ii.min + 1, ii.max - 1], d)


def _random_bits(rng, d: np.dtype, n: int) -> np.ndarray:
    u = np.dtype(f"u{d.itemsize}")
    return rng.integers(0, np.iinfo(u).max, n, dtype=u,
                        endpoint=True).view(d)


def _keys(d, n=N, seed=0):
    """Random bit patterns (every NaN payload a float can carry), 60% of
    them replaced by draws from a pool of 30 values and the specials, so
    keys repeat and groups form."""
    d = np.dtype(d)
    rng = np.random.default_rng(seed)
    keys = _random_bits(rng, d, n)
    pool = np.concatenate([_random_bits(rng, d, 30), _specials(d)])
    pick = rng.random(n) < 0.6
    keys[pick] = rng.choice(pool, int(pick.sum()))
    keys[:len(_specials(d))] = _specials(d)
    return keys


def _values(d, n=N, seed=1):
    """A value column with the specials and one NaN pattern."""
    d = np.dtype(d)
    rng = np.random.default_rng(seed)
    v = _random_bits(rng, d, n)
    if d.kind == "f":
        v[np.isnan(v)] = 3
    pick = rng.random(n) < 0.3
    v[pick] = rng.choice(_specials(d), int(pick.sum()))
    return v


def _small(d, n=N, seed=2):
    """Small integers in dtype ``d``: exact sums in any order."""
    d = np.dtype(d)
    lo = 0 if d.kind == "u" else -3
    return np.random.default_rng(seed).integers(lo, 4, n).astype(d)


def _t(a):
    return tdt.tensor_from_numpy(np.asarray(a), "cpu")


def _bits_equal(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8),
                                  err_msg=what)


def _subnormal(x: np.ndarray) -> np.ndarray:
    """float32/float64 subnormals (XLA's CPU code flushes them; float16
    runs in float32 there, where its subnormals are normal numbers)."""
    if x.dtype.itemsize < 4:
        return np.zeros(x.shape, bool)
    return (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)


def _ftz(x: np.ndarray) -> np.ndarray:
    """A float selection as XLA's CPU min/max give it: float32/float64
    subnormals flushed to a zero of their sign."""
    x = x.copy()
    sub = _subnormal(x)
    x[sub] = np.copysign(np.zeros_like(x[sub]), x[sub])
    return x


def _scan_image(x: np.ndarray) -> np.ndarray:
    """A float selection as a JAX associative scan gives it on the CPU:
    the scan adds the zero padding of its interleave, so -0.0 and the
    flushed subnormals become +0.0 and a signaling NaN is quieted (its
    payload kept)."""
    x = x.copy()
    x[(x == 0) | _subnormal(x)] = 0
    u = x.view(f"u{x.itemsize}")
    quiet = u.dtype.type(1 << (np.finfo(x.dtype).nmant - 1))
    u[np.isnan(x)] |= quiet
    return x


def _tables(cols, num_rows=NUM_ROWS):
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                num_rows=num_rows)
    tt = Table({k: _t(v) for k, v in cols.items()}, num_rows=num_rows)
    return jt, tt


def _valid_rows_equal(got: Table, want: JTable):
    assert int(got.num_rows) == int(want.num_rows)
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for k in w:
        _bits_equal(g[k], w[k], k)


def _capacity_equal(got: Table, want: JTable):
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    for k, w in want.columns.items():
        _bits_equal(tdt.tensor_to_numpy(got[k]), w, k)


dtype_cases = pytest.mark.parametrize("dtype", DTYPES, ids=IDS)


# ---- sort, sort_kv, argsort -------------------------------------------------

@dtype_cases
def test_sort_kv(dtype):
    keys = _keys(dtype)
    iota = np.arange(N, dtype=np.int32)
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(iota))
    tk, tv = rtt.sort_kv(_t(keys), _t(iota))
    _bits_equal(tdt.tensor_to_numpy(tk), jk, "keys")
    _bits_equal(tv.numpy(), jv, "payload")


@dtype_cases
def test_sort(dtype):
    keys = _keys(dtype, seed=3)
    _bits_equal(tdt.tensor_to_numpy(rtt.sort(_t(keys))),
                rst.sort(jnp.asarray(keys)))


@dtype_cases
def test_argsort(dtype):
    keys = _keys(dtype, seed=4)
    _bits_equal(rtt.argsort(_t(keys)).numpy(), rst.argsort(jnp.asarray(keys)))


NARROW = [np.uint8, np.int8, np.float16]
NARROW_IDS = ["u8", "i8", "f16"]


@pytest.mark.parametrize("engine", ["auto", "radix", "merge", "torch_sort",
                                    "chunked"])
@pytest.mark.parametrize("dtype", NARROW, ids=NARROW_IDS)
def test_sort_kv_every_engine(dtype, engine):
    """Every engine name sorts 1-byte and half keys; ``merge`` (key-only
    32-bit keys) runs ``radix`` for them, as for 16-bit keys."""
    keys = _keys(dtype, seed=24)
    iota = np.arange(N, dtype=np.int32)
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(iota))
    tk, tv = rtt.sort_kv(_t(keys), _t(iota), engine=engine)
    _bits_equal(tdt.tensor_to_numpy(tk), jk, "keys")
    _bits_equal(tv.numpy(), jv, "payload")


@pytest.mark.parametrize("dtype", NARROW, ids=NARROW_IDS)
def test_chunked_sort_at_key_width(dtype):
    """The range-chunked sort partitions and sorts 8- and 16-bit images
    at their own width (8 chunks over 4096 rows)."""
    n = 4096
    keys = _keys(dtype, n, seed=25)
    iota = np.arange(n, dtype=np.int32)
    bits, (perm,) = chunked_sort.sort_chunked_biased(
        tdt.to_sortable(_t(keys)), (_t(iota),), k_chunks=8, min_n=1024,
        total_bits=tdt.key_bits(dtype))
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(iota))
    _bits_equal(tdt.tensor_to_numpy(tdt.from_sortable(bits, dtype)), jk)
    _bits_equal(perm.numpy(), jv)


@dtype_cases
def test_sort_config_num_passes(dtype):
    """Passes a key of ``dtype`` takes at each digit width, as the JAX
    SortConfig counts them; a digit wider than the key raises ValueError
    in both packages (the port's SortConfig refuses 16-bit digits at
    construction, since its kernels keep one counter row a digit)."""
    for bits in (1, 2, 4, 8):
        assert (rtt.SortConfig(bits_per_pass=bits).num_passes(dtype)
                == rst.SortConfig(bits_per_pass=bits).num_passes(dtype))
    if np.dtype(dtype).itemsize == 1:
        with pytest.raises(ValueError):
            rst.SortConfig(bits_per_pass=16).num_passes(dtype)
    with pytest.raises(ValueError):
        rtt.SortConfig(bits_per_pass=16).num_passes(dtype)


@dtype_cases
def test_filter_expr(dtype):
    """A comparison against a value of the column (NaN compares false in
    both packages, -0.0 equals +0.0)."""
    keys = _keys(dtype, seed=26)
    value = keys[17].item()
    jt, tt = _tables({"k": keys, "row": np.arange(N, dtype=np.int32)})
    for op in ("lt", "ge"):
        _valid_rows_equal(
            filt.filter_expr(tt, "k", op, value),
            jax.jit(lambda t: jfilt.filter_expr(t, "k", op, value))(jt))


# ---- top_k, top_k_kv, topk_table -------------------------------------------

@pytest.mark.parametrize("k,largest", [(7, True), (600, False)],
                         ids=["k7-largest", "k600-smallest"])
@dtype_cases
def test_top_k(dtype, k, largest):
    keys = _keys(dtype, seed=5)
    _bits_equal(tdt.tensor_to_numpy(rtt.top_k(_t(keys), k, largest=largest)),
                rst.top_k(jnp.asarray(keys), k, largest=largest))


@dtype_cases
def test_top_k_kv(dtype):
    keys = _keys(dtype, seed=6)
    vals = {"row": np.arange(N, dtype=np.int32), "v": _values(dtype)}
    jk, jv = jtopk.top_k_kv(jnp.asarray(keys),
                            {k: jnp.asarray(v) for k, v in vals.items()}, 40,
                            largest=False)
    tk, tv = topk.top_k_kv(_t(keys), {k: _t(v) for k, v in vals.items()}, 40,
                           largest=False)
    _bits_equal(tdt.tensor_to_numpy(tk), jk, "keys")
    for name in vals:
        _bits_equal(tdt.tensor_to_numpy(tv[name]), jv[name], name)


@dtype_cases
def test_topk_table(dtype):
    jt, tt = _tables({"k": _keys(dtype, seed=7),
                      "row": np.arange(N, dtype=np.int32)})
    want = jax.jit(lambda t: jtopk.topk_table(t, "k", 100))(jt)
    _capacity_equal(topk.topk_table(tt, "k", 100), want)


# ---- hash_aggregate, distinct, hash_join -----------------------------------

@pytest.mark.parametrize("method", ["scan", "segment"])
@dtype_cases
def test_hash_aggregate(dtype, method):
    """count, sum, min, max and mean grouped by a key of ``dtype`` over
    columns of ``dtype``; the segment method on every row of the capacity
    (the empty segments' identities included)."""
    jt, tt = _tables({"k": _keys(dtype, seed=8), "v": _values(dtype),
                      "w": _small(dtype)})
    want = jax.jit(lambda t: jagg.hash_aggregate(t, "k", AGGS,
                                                 method=method))(jt)
    got = aggregate.hash_aggregate(tt, "k", AGGS, method=method)
    if np.dtype(dtype).kind == "f":
        # the port's two methods select the same bits; the JAX package's
        # arithmetic maps them as the module docstring says
        other = aggregate.hash_aggregate(
            tt, "k", AGGS, method="segment" if method == "scan" else "scan")
        for c in ("lo", "hi"):
            _bits_equal(got.to_numpy()[c], other.to_numpy()[c], c)
        jax_image = _scan_image if method == "scan" else _ftz
        got = got.with_columns(**{c: _t(jax_image(tdt.tensor_to_numpy(
            got[c]))) for c in ("lo", "hi")})
    if method == "segment":
        _capacity_equal(got, want)
    else:
        _valid_rows_equal(got, want)


@dtype_cases
def test_distinct(dtype):
    jt, tt = _tables({"k": _keys(dtype, seed=9), "v": _values(dtype),
                      "row": np.arange(N, dtype=np.int32)})
    _valid_rows_equal(aggregate.distinct(tt, "k"),
                      jax.jit(lambda t: jagg.distinct(t, "k"))(jt))


@dtype_cases
def test_hash_join(dtype):
    probe = _keys(dtype, seed=10)
    u = np.dtype(f"u{np.dtype(dtype).itemsize}")
    distinct_bits = np.unique(probe.view(u))
    rng = np.random.default_rng(11)
    build = rng.permutation(distinct_bits)[:min(150, distinct_bits.size)]
    build = build.view(dtype)
    jp, tp = _tables({"k": probe, "pv": np.arange(N, dtype=np.int32)})
    jb, tb = _tables({"k": build, "bv": _values(dtype, build.size)},
                     num_rows=build.size - 5)
    jres, jstats = jax.jit(lambda p, b: jjoin.hash_join(p, b, "k"))(jp, jb)
    tres, tstats = join.hash_join(tp, tb, "k")
    assert int(tstats["match_count"]) == int(jstats["match_count"]) > 0
    assert bool(tstats["overflow"]) == bool(jstats["overflow"])
    if np.dtype(dtype).kind == "f":
        # each match carries its build row's value bits (the JAX fill
        # scan maps them, as the module docstring says)
        bv = dict(zip(build.view(u).tolist(), _values(dtype, build.size)))
        got = tres.to_numpy()
        want_bv = [bv[int(b)] for b in probe[got["pv"]].view(u)]
        _bits_equal(got["bv"], np.array(want_bv, dtype), "bv")
        tres = tres.with_columns(**{c: _t(_scan_image(tdt.tensor_to_numpy(
            tres[c]))) for c in ("bv", "k_r")})
    _valid_rows_equal(tres, jres)


# ---- 8-byte payloads --------------------------------------------------------
#
# int64, uint64 and float64 payload columns ride the radix passes as one
# 8-byte plane each: bits, never values, so every NaN payload and -0.0
# survive.  Keys are int32 (u8 for the narrow pass), repeating, so
# stability shows; an int32 row id checks it against golden.oracle_argsort.

WIDE = [np.int64, np.uint64, np.float64]
WIDE_IDS = ["i64", "u64", "f64"]
WIDE_ENTRIES = ["sort_kv", "sort_kv_narrow_key", "stable_partition",
                "hash_aggregate", "distinct", "query", "query_uncut"]


def _wide_payload(d, n=N, seed=27):
    """Random bits of ``d`` with the specials planted; float64 with NaNs
    of several payloads and signs, -0.0 and +0.0 among them."""
    d = np.dtype(d)
    v = _random_bits(np.random.default_rng(seed), d, n)
    plants = _specials(d)
    if d.kind == "f":
        nans = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                         0x7FF0000000000001, 0x7FF4000000000ABC],
                        np.uint64).view(d)
        plants = np.concatenate([plants, nans, np.array([-0.0, 0.0], d)])
    v[3::7][:len(plants) * 8] = np.tile(plants, 8)[:v[3::7].size]
    return v


@pytest.mark.parametrize("entry", WIDE_ENTRIES)
@pytest.mark.parametrize("dtype", WIDE, ids=WIDE_IDS)
def test_wide_payloads(dtype, entry):
    """Each entry point that sorts or partitions rows, with an 8-byte
    payload of ``dtype``: keys and payloads bit for bit the JAX package's,
    and the row ids the stable order of golden.oracle_argsort."""
    keys = _keys(np.int32, seed=28) % 40
    pay = _wide_payload(dtype)
    row = np.arange(N, dtype=np.int32)
    if entry in ("sort_kv", "sort_kv_narrow_key"):
        if entry == "sort_kv_narrow_key":
            keys = keys.astype(np.uint8)
        jk, (jp, jr) = rst.sort_kv(jnp.asarray(keys),
                                   (jnp.asarray(pay), jnp.asarray(row)))
        tk, (tp, tr) = rtt.sort_kv(_t(keys), (_t(pay), _t(row)))
        order = golden.oracle_argsort(keys)
        _bits_equal(tdt.tensor_to_numpy(tk), jk, "keys")
        _bits_equal(tdt.tensor_to_numpy(tp), jp, "payload")
        _bits_equal(tr.numpy(), jr, "row")
        _bits_equal(tdt.tensor_to_numpy(tp), pay[order], "payload order")
        np.testing.assert_array_equal(tr.numpy(), order)
    elif entry == "stable_partition":
        ids = (keys % 7).astype(np.int32)
        jo, jc, _ = jpart.stable_partition(
            jnp.asarray(ids), (jnp.asarray(pay), jnp.asarray(row)), 7,
            method="sort")
        (tp, tr), tc, _ = partition.stable_partition(
            _t(ids), (_t(pay), _t(row)), 7, method="stream")
        order = golden.oracle_argsort(ids)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        _bits_equal(tdt.tensor_to_numpy(tp), jo[0], "payload")
        _bits_equal(tdt.tensor_to_numpy(tp), pay[order], "payload order")
        np.testing.assert_array_equal(tr.numpy(), order)
    elif entry == "hash_aggregate":
        # min/max select a row of the 8-byte column (one NaN pattern, as
        # the module docstring says); sums add small integers exactly
        vals = _values(dtype)
        jt, tt = _tables({"k": keys, "v": vals, "w": _small(dtype)})
        want = jax.jit(lambda t: jagg.hash_aggregate(t, "k", AGGS,
                                                     method="segment"))(jt)
        got = aggregate.hash_aggregate(tt, "k", AGGS, method="segment")
        if np.dtype(dtype).kind == "f":
            got = got.with_columns(**{c: _t(_ftz(tdt.tensor_to_numpy(
                got[c]))) for c in ("lo", "hi")})
        _capacity_equal(got, want)
    elif entry == "distinct":
        jt, tt = _tables({"k": keys, "p": pay, "row": row})
        got = aggregate.distinct(tt, "k")
        _valid_rows_equal(got, jax.jit(lambda t: jagg.distinct(t, "k"))(jt))
        valid = keys[:NUM_ROWS]
        order = golden.oracle_argsort(valid)
        first = order[np.r_[True, valid[order][1:] != valid[order][:-1]]]
        g = got.to_numpy()
        np.testing.assert_array_equal(g["row"], first)
        _bits_equal(g["p"], pay[first], "payload of each first row")
    elif entry == "query_uncut":
        # no step changes the count, so nothing is cut: every row of the
        # capacity, padding included, is the JAX package's
        jt, tt = _tables({"k": keys, "p": pay, "row": row})

        def chain(q):
            return q.with_column("p2", lambda t: t["p"]).sort_by("k")

        want = jax.jit(lambda t: chain(JQuery(t)).collect())(jt)
        got = chain(Query(tt)).collect()
        _capacity_equal(got, want)
        order = golden.oracle_argsort(keys[:NUM_ROWS])
        g = got.to_numpy()
        np.testing.assert_array_equal(g["row"], order)
        _bits_equal(g["p2"], pay[order], "payload order")
    else:
        jt, tt = _tables({"k": keys, "p": pay, "row": row})
        want = jax.jit(lambda t: JQuery(t).filter("row", "ge", 3).sort_by(
            "k").collect())(jt)
        got = Query(tt).filter("row", "ge", 3).sort_by("k").collect()
        # the sort runs on the filter's valid rows, cut from its capacity:
        # the result has the JAX capacity, and its rows past num_rows are
        # unwritten padding (Query's module docstring)
        assert got.capacity == want.capacity
        _valid_rows_equal(got, want)
        kept = np.arange(3, NUM_ROWS)
        order = kept[golden.oracle_argsort(keys[kept])]
        g = got.to_numpy()
        np.testing.assert_array_equal(g["row"], order)
        _bits_equal(g["p"], pay[order], "payload order")


# ---- window, segmented_sort, segmented_sort_kv -----------------------------

@dtype_cases
def test_window(dtype):
    """Every window kind, partitioned and ordered by keys of ``dtype``,
    over value columns of ``dtype``, with masked rows."""
    part, order = _keys(dtype, seed=12), _keys(dtype, seed=13)
    cols = {"v": _values(dtype), "w": _small(dtype)}
    valid = np.random.default_rng(14).random(N) < 0.9
    fn = jax.jit(lambda p, o, c, m: jwin.window(p, o, WINDOW_KINDS, c,
                                                valid=m))
    want = fn(jnp.asarray(part), jnp.asarray(order),
              {k: jnp.asarray(v) for k, v in cols.items()},
              jnp.asarray(valid))
    got = win.window(_t(part), _t(order), WINDOW_KINDS,
                     {k: _t(v) for k, v in cols.items()}, valid=_t(valid))
    assert set(got) == set(want)
    for name in want:
        g = tdt.tensor_to_numpy(got[name])
        if name in ("mn", "mx", "fv") and g.dtype.kind == "f":
            g = _scan_image(g)  # the JAX scan's arithmetic, see above
        _bits_equal(g, want[name], name)


@dtype_cases
def test_segmented_sort(dtype):
    seg = np.sort(_keys(dtype, seed=15))
    keys = _keys(dtype, seed=16)
    _bits_equal(tdt.tensor_to_numpy(win.segmented_sort(_t(seg), _t(keys))),
                jax.jit(jwin.segmented_sort)(jnp.asarray(seg),
                                             jnp.asarray(keys)))


@dtype_cases
def test_segmented_sort_kv(dtype):
    seg = np.sort(_keys(dtype, seed=17))
    keys = _keys(dtype, seed=18)
    vals = {"row": np.arange(N, dtype=np.int32), "v": _values(dtype)}
    jk, jv = jax.jit(jwin.segmented_sort_kv)(
        jnp.asarray(seg), jnp.asarray(keys),
        {k: jnp.asarray(v) for k, v in vals.items()})
    tk, tv = win.segmented_sort_kv(_t(seg), _t(keys),
                                   {k: _t(v) for k, v in vals.items()})
    _bits_equal(tdt.tensor_to_numpy(tk), jk, "keys")
    # the JAX sort is unstable on its (segment, key, position) keys, which
    # are unique, so the payloads are defined
    for name in vals:
        _bits_equal(tdt.tensor_to_numpy(tv[name]), jv[name], name)


# ---- Query.sort_by ----------------------------------------------------------

@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
@dtype_cases
def test_query_sort_by(dtype, descending):
    jt, tt = _tables({"k": _keys(dtype, seed=19),
                      "row": np.arange(N, dtype=np.int32)})
    want = jax.jit(lambda t: JQuery(t).sort_by(
        "k", descending=descending).collect())(jt)
    _capacity_equal(Query(tt).sort_by("k", descending=descending).collect(),
                    want)


# ---- io, Table.to_numpy, datasets_device ----------------------------------

@dtype_cases
def test_io_and_to_numpy(dtype, tmp_path):
    """Files written by either package load in the other, every row of
    the capacity bit for bit, and ``Table.to_numpy`` gives the valid
    rows in the column's dtype."""
    cols = {"k": _keys(dtype, seed=20), "v": _values(dtype)}
    jt, tt = _tables(cols)
    _valid_rows_equal(tt, jt)
    back = jio.load_table(tio.save_table(tt, str(tmp_path / "port")))
    _capacity_equal(tt, back)
    loaded = tio.load_table(jio.save_table(jt, str(tmp_path / "jax")),
                            device="cpu")
    _capacity_equal(loaded, jt)


@dtype_cases
def test_datasets_device(dtype):
    """Zeros, Range and InvertedRange equal the JAX twins' bits; the
    random datasets have the dtype and the shape (n,), the dtype's
    extremes planted at both ends of RandomDistributed (+-inf for floats)
    and finite floats between them.  The
    random bits are the port's own, not ``jax.random``'s (for 1- and
    2-byte signed ints the JAX twin returns an (n, 8 / itemsize) array,
    and for float16 NaN between the plants, as its [-1e9, 1e9) range
    overflows the dtype)."""
    d = np.dtype(dtype)
    for name in ("Zeros", "Range", "InvertedRange"):
        got = tdt.tensor_to_numpy(dd.generate(name, d, N, device="cpu"))
        _bits_equal(got, jdd.generate(name, d, N), name)
    got = tdt.tensor_to_numpy(dd.generate("RandomDistributed", d, N, seed=3,
                                          device="cpu"))
    assert got.dtype == d and got.shape == (N,)
    if d.kind == "f":
        assert got[0] == -np.inf and got[-1] == np.inf
        assert np.isfinite(got[1:-1]).all()
    else:
        assert got[0] == np.iinfo(d).min and got[-1] == np.iinfo(d).max
    rnd = tdt.tensor_to_numpy(dd.generate("Random", d, N, seed=3,
                                          device="cpu"))
    _bits_equal(rnd[1:-1], got[1:-1], "Random = RandomDistributed inside")


# ---- dtypes both packages refuse -------------------------------------------

REFUSED = {"bool": (np.bool_, torch.bool),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
REFUSING = {
    "sort": (lambda k: rst.sort(k), lambda k: rtt.sort(k)),
    "top_k": (lambda k: rst.top_k(k, 3), lambda k: rtt.top_k(k, 3)),
    "hash_aggregate": (
        lambda k: jagg.hash_aggregate(JTable({"k": k}), "k",
                                      {"n": ("count", None)}),
        lambda k: aggregate.hash_aggregate(Table({"k": k}), "k",
                                           {"n": ("count", None)})),
    "window": (lambda k: jwin.window(k, k, {"rn": ("row_number",)}),
               lambda k: win.window(k, k, {"rn": ("row_number",)})),
}


@pytest.mark.parametrize("entry", list(REFUSING))
@pytest.mark.parametrize("dtype", list(REFUSED))
def test_refused_key_dtypes_raise_type_error(dtype, entry):
    jdtype, tdtype = REFUSED[dtype]
    jfn, tfn = REFUSING[entry]
    with pytest.raises(TypeError):
        jfn(jnp.zeros(16, jdtype))
    with pytest.raises(TypeError):
        tfn(torch.zeros(16, dtype=tdtype))


# ---- the number of radix passes --------------------------------------------

class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        self.calls.append(a)
        return self.fn(*a, **k)


@pytest.mark.parametrize("dtype,passes", [(np.uint8, 1), (np.int8, 1),
                                          (np.float16, 2), (np.int16, 2),
                                          (np.uint16, 2)],
                         ids=["u8", "i8", "f16", "i16", "u16"])
def test_narrow_keys_run_one_pass_a_byte(dtype, passes, monkeypatch):
    """An 8-bit key sort runs one radix pass and a 16-bit one two: one
    pass_histograms over one key plane for that many passes, and one
    onesweep_pass each (spied on the kernels' plain versions, which the
    wrappers run on the CPU).  The key plane handed to both is the
    caller's keys at their own 1- or 2-byte width (uint16 as its int16
    view), with the key's kind, and no transform to a sortable image runs
    on the way (``dtypes.to_sortable`` / ``from_sortable`` are not
    called): the kernels take the image in registers."""
    hist = _Spy(cr.pass_histograms_plain)
    sweep = _Spy(cr.onesweep_pass_plain)
    transforms = [_Spy(tdt.to_sortable), _Spy(tdt.from_sortable)]
    monkeypatch.setattr(cr, "pass_histograms_plain", hist)
    monkeypatch.setattr(cr, "onesweep_pass_plain", sweep)
    monkeypatch.setattr(tdt, "to_sortable", transforms[0])
    monkeypatch.setattr(tdt, "from_sortable", transforms[1])
    keys = _keys(dtype, seed=21)
    tk, tv = rtt.sort_kv(_t(keys), torch.arange(N, dtype=torch.int32))
    assert len(hist.calls) == 1
    planes, pass_counts = hist.calls[0][0], hist.calls[0][1]
    assert len(planes) == 1 and tuple(pass_counts) == (passes,)
    assert len(sweep.calls) == passes
    want = tdt.container_dtype(keys.dtype)
    kind = np.dtype(dtype).kind
    assert planes[0].dtype == want
    assert planes[0].element_size() == np.dtype(dtype).itemsize
    assert hist.calls[0][3] == kind
    for call in sweep.calls:
        assert call[0].dtype == want and call[1][0].dtype == want
    assert [t.calls for t in transforms] == [[], []]
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.arange(N, dtype=jnp.int32))
    _bits_equal(tdt.tensor_to_numpy(tk), jk)
    _bits_equal(tv.numpy(), jv)


# ---- on the card ------------------------------------------------------------

CUDA_N = 1 << 20


def _on(device, a):
    return tdt.tensor_from_numpy(np.asarray(a), device)


@pytest.mark.cuda
@dtype_cases
def test_cuda_sort_kv_passes_and_cpu_parity(cuda_device, dtype):
    """sort_kv at 2^20 on the card equals the port's CPU result bit for
    bit, in one pass_histograms launch and one onesweep_pass launch for
    each 8 bits of key."""
    keys = _keys(dtype, CUDA_N, seed=22)
    iota = np.arange(CUDA_N, dtype=np.int32)
    cr.reset_launch_counts()
    ck, cv = rtt.sort_kv(_on(cuda_device, keys), _on(cuda_device, iota))
    torch.cuda.synchronize()
    counts = cr.launch_counts()
    assert counts["pass_histograms"] == 1
    assert counts["onesweep_pass"] == np.dtype(dtype).itemsize
    hk, hv = rtt.sort_kv(_t(keys), _t(iota))
    _bits_equal(tdt.tensor_to_numpy(ck), tdt.tensor_to_numpy(hk), "keys")
    _bits_equal(cv.cpu().numpy(), hv.numpy(), "payload")


@pytest.mark.cuda
@dtype_cases
def test_cuda_operators_match_cpu(cuda_device, dtype):
    """hash_aggregate (both methods), top_k, window and Query.sort_by
    (descending) at 2^20 on the card against the port's CPU results."""
    cols = {"k": _keys(dtype, CUDA_N, seed=23),
            "v": _values(dtype, CUDA_N), "w": _small(dtype, CUDA_N)}
    results = []
    for dev in (cuda_device, "cpu"):
        t = Table({k: _on(dev, v) for k, v in cols.items()},
                  num_rows=CUDA_N - 100)
        out = {}
        for method in ("scan", "segment"):
            agg = aggregate.hash_aggregate(t, "k", AGGS, method=method)
            out.update({f"{method}.{k}": v
                        for k, v in agg.to_numpy().items()})
        out["top_k"] = tdt.tensor_to_numpy(rtt.top_k(t["k"], 1000))
        w = win.window(t["k"], t["v"], WINDOW_KINDS,
                       {"v": t["v"], "w": t["w"]})
        out.update({f"window.{k}": tdt.tensor_to_numpy(v)
                    for k, v in w.items()})
        desc = Query(t).sort_by("k", descending=True).collect()
        out.update({f"sort_by.{k}": v for k, v in desc.to_numpy().items()})
        results.append(out)
    assert set(results[0]) == set(results[1])
    for name in results[1]:
        _bits_equal(results[0][name], results[1][name], name)
