"""The device plan of the port's radix passes: no host read, no aliasing.

A sort or a partition decides on the card which passes one digit fills
(every launch of a pass derives the plan from the pass table), so it reads
nothing back to the host, and its result is always storage of its own, as
a JAX sort's is a new value.  Before the plan, a sort whose every pass was
filled handed back the caller's own tensors (``sort_kv`` of int32 zeros
returned the caller's payload; of uint8 zeros its keys too;
``compact_mask`` of an all-True mask returned its arrays).

Every case here runs on the CPU, where the wrappers run the kernels' plain
versions with the same plan, and asserts that ``stream.host_reads`` did not
move, that no output shares storage with an input and writing into the
outputs leaves the inputs as they were, and that the result equals the JAX
package's bit for bit.  The JAX side runs on the CPU as the rest of the
suite runs it: its Pallas engine in interpret mode where a case names it
(8-bit sorts; the two-bucket partition and the compaction), else its
default engine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.config import SortConfig as JaxSortConfig
from radix_sort_tpu.ops import aggregate as jagg, filter as jfilt
from radix_sort_tpu.ops import join as jjoin, partition as jpart
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import aggregate, filter as filt, join
from radix_sort_tpu_torch.ops import partition, stream

N = 3001
TILE = 2048
# key dtypes: a 64-bit key whose high word fills its four passes, and the
# 8-bit and half keys of the narrow pass
KEY_DTYPES = {"u32": np.uint32, "i32": np.int32, "u64_high_filled": np.uint64,
              "u8": np.uint8, "i8": np.int8, "f16": np.float16}
DISTS = ["Zeros", "RandomDistributed", "Range"]
# sorts the JAX side runs on its Pallas engine (interpret mode)
PALLAS_SORTS = ("u8", "i8")


def _keys(name: str, dist: str, n: int = N) -> np.ndarray:
    d = np.dtype(KEY_DTYPES[name])
    if dist == "Zeros":
        return np.zeros(n, d)
    if dist == "Range":
        return rtt.datasets.Range(d).generate(n)
    rng = np.random.default_rng(len(name))
    if d.kind == "f":  # RandomDistributed's [-1e9, 1e9) overflows float16
        return rng.integers(0, 1 << 16, n, dtype=np.uint16).view(d)
    keys = rtt.datasets.RandomDistributed(d, seed=3).generate(n)
    if d.itemsize == 8:
        keys &= np.uint64(0xFFFFFFFF)
    return keys


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as a signed integer tensor of its width."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _bits_equal(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(tdt.tensor_to_numpy(got).view(np.uint8),
                                  np.asarray(want).view(np.uint8))


def _reads_nothing(fn):
    """fn()'s result; the sort path read nothing back to the host."""
    reads = stream.host_reads
    out = fn()
    assert stream.host_reads == reads
    return out


def _assert_fresh(outs, ins) -> None:
    """No output shares storage with an input, and writing every bit of
    the outputs leaves the inputs as they were."""
    outs = [o for o in outs if o.numel()]
    held = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    for o in outs:
        assert o.untyped_storage().data_ptr() not in held
    saved = [_bits(t).clone() for t in ins]
    for o in outs:
        _bits(o).bitwise_not_()
    for t, s in zip(ins, saved):
        assert torch.equal(_bits(t), s)


# ------------------------------------------------------------------ sorts

@functools.cache
def _jax_sort(name: str, dist: str, op: str):
    kw = ({"config": JaxSortConfig(bits_per_pass=8, block_elems=TILE,
                                   engine="pallas")}
          if name in PALLAS_SORTS else {})
    keys = jnp.asarray(_keys(name, dist))
    if op == "sort":
        return (np.asarray(rst.sort(keys, **kw)),)
    if op == "argsort":
        return (np.asarray(rst.argsort(keys, **kw)),)
    jk, jv = rst.sort_kv(keys, jnp.arange(N, dtype=jnp.int32) * 3, **kw)
    return np.asarray(jk), np.asarray(jv)


@pytest.mark.parametrize("op", ["sort", "sort_kv", "argsort"])
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", list(KEY_DTYPES))
def test_sort_entry_points_read_nothing_and_never_alias(name, dist, op):
    tk = tdt.tensor_from_numpy(_keys(name, dist), "cpu")
    vals = torch.arange(N, dtype=torch.int32) * 3
    if op == "sort":
        ins, outs = (tk,), (_reads_nothing(lambda: rtt.sort(tk)),)
    elif op == "argsort":
        ins, outs = (tk,), (_reads_nothing(lambda: rtt.argsort(tk)),)
    else:
        ins, outs = (tk, vals), _reads_nothing(lambda: rtt.sort_kv(tk, vals))
    want = _jax_sort(name, dist, op)
    if op == "argsort":
        np.testing.assert_array_equal(outs[0].numpy(), want[0])
    else:
        _bits_equal(outs[0], want[0])
    if op == "sort_kv":
        np.testing.assert_array_equal(outs[1].numpy(), want[1])
    _assert_fresh(outs, ins)


# ------------------------------------------------- partition, compaction

def _arrays(rng, n: int = N) -> dict:
    return {"f": rng.standard_normal(n).astype(np.float32),
            "i": np.arange(n, dtype=np.int32),
            "u": rng.integers(0, 2**32, n, dtype=np.uint32),
            "l": rng.integers(-2**62, 2**62, n).astype(np.int64),
            "h": rng.standard_normal(n).astype(np.float16)}


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jax_partition(ids, arrays, nb, method):
    return jpart.stable_partition(ids, arrays, nb, method=method)


@pytest.mark.parametrize("ids_dist", ["random", "one_bucket"])
@pytest.mark.parametrize("nb", [1, 2, 256, 1000])
def test_stable_partition_stream(nb, ids_dist):
    """One pass up to 256 buckets (a copy where one bucket holds every
    row), two 8-bit passes for 1000; the JAX side's stream pass (Pallas,
    interpret mode) for one and two buckets, its sort above."""
    rng = np.random.default_rng(nb)
    ids = (rng.integers(0, nb, N) if ids_dist == "random"
           else np.full(N, nb - 1)).astype(np.int32)
    arrs = _arrays(rng)
    names = sorted(arrs)
    tids = torch.from_numpy(ids)
    tarr = tuple(tdt.tensor_from_numpy(arrs[k], "cpu") for k in names)
    out, counts, starts = _reads_nothing(lambda: partition.stable_partition(
        tids, tarr, nb, method="stream"))
    jout, jcounts, jstarts = _jax_partition(
        jnp.asarray(ids), tuple(jnp.asarray(arrs[k]) for k in names), nb,
        "stream" if nb <= 2 else "sort")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(jstarts))
    for x, y in zip(out, jout):
        _bits_equal(x, y)
    _assert_fresh(tuple(out) + (counts, starts), (tids,) + tarr)


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_compact(mask, arrays, method):
    return jpart.compact_mask(mask, arrays, method=method)


@pytest.mark.parametrize("case", ["all_kept", "none_kept", "mixed"])
def test_compact_mask_stream(case):
    """compact_mask(method="stream") (both packages default to "sort")
    against the JAX stream pass in interpret mode."""
    rng = np.random.default_rng(8)
    mask = {"all_kept": np.ones(N, bool), "none_kept": np.zeros(N, bool),
            "mixed": rng.random(N) < 0.3}[case]
    arrs = _arrays(rng)
    names = sorted(arrs)
    tmask = torch.from_numpy(mask)
    tarr = tuple(tdt.tensor_from_numpy(arrs[k], "cpu") for k in names)
    out, kept = _reads_nothing(lambda: partition.compact_mask(
        tmask, tarr, method="stream"))
    jout, jkept = _jax_compact(jnp.asarray(mask),
                               tuple(jnp.asarray(arrs[k]) for k in names),
                               "stream")
    assert int(kept) == int(jkept)
    for x, y in zip(out, jout):
        _bits_equal(x, y)
    _assert_fresh(tuple(out) + (kept,), (tmask,) + tarr)


# ------------------------------------------------- filter, aggregate, join

def _both(cols: dict, num_rows: int):
    """The same numpy columns as a JAX Table and as the port's (CPU)."""
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                num_rows=num_rows)
    tt = convert.table_from_numpy(
        {k: np.asarray(v) for k, v in jt.columns.items()},
        num_rows=np.asarray(jt.num_rows), device="cpu")
    return jt, tt


def _table_tensors(t) -> tuple:
    return tuple(t.columns[k] for k in t.column_names) + (t.num_rows,)


def _tables_equal(got, want) -> None:
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, k
        np.testing.assert_array_equal(g[k].view(np.uint8),
                                      w[k].view(np.uint8), err_msg=k)


@pytest.mark.parametrize("case", ["all_kept", "none_kept", "mixed"])
@pytest.mark.parametrize("name", ["u32", "u8"])
def test_filter_expr(name, case):
    rng = np.random.default_rng(11)
    k = rng.integers(0, 100, N).astype(KEY_DTYPES[name])
    value = {"all_kept": 100, "none_kept": 0, "mixed": 50}[case]
    jt, tt = _both({"k": k, "x": np.arange(N, dtype=np.int32)}, N - 50)
    got = _reads_nothing(lambda: filt.filter_expr(tt, "k", "lt", value))
    _tables_equal(got, jax.jit(lambda t: jfilt.filter_expr(
        t, "k", "lt", value))(jt))
    _assert_fresh(_table_tensors(got), _table_tensors(tt))


AGGS = {"n": ("count", None), "s": ("sum", "x"), "lo": ("min", "x"),
        "hi": ("max", "x")}


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("name", ["u32", "u64_high_filled", "u8", "f16"])
def test_hash_aggregate(name, dist):
    rng = np.random.default_rng(12)
    x = rng.integers(-1000, 1000, N).astype(np.int32)
    jt, tt = _both({"k": _keys(name, dist), "x": x}, N - 40)
    got = _reads_nothing(lambda: aggregate.hash_aggregate(tt, "k", AGGS))
    _tables_equal(got, jax.jit(lambda t: jagg.hash_aggregate(
        t, "k", AGGS))(jt))
    _assert_fresh(_table_tensors(got), _table_tensors(tt))


@pytest.mark.parametrize("dist", DISTS)
def test_hash_join(dist):
    """A u32 probe of each distribution against a unique build that holds
    key 0 (every Zeros probe row matches)."""
    rng = np.random.default_rng(13)
    pk = _keys("u32", dist) % np.uint32(4000)
    bk = np.concatenate([[0], rng.permutation(np.arange(1, 4000))[:999]])
    jp, tp = _both({"k": pk, "pv": np.arange(N, dtype=np.int32)}, N - 30)
    jb, tb = _both({"k": bk.astype(np.uint32),
                    "bv": (bk * 3).astype(np.int32)}, 990)
    got, stats = _reads_nothing(lambda: join.hash_join(tp, tb, "k"))
    want, jstats = jax.jit(lambda p, b: jjoin.hash_join(p, b, "k"))(jp, jb)
    assert int(stats["match_count"]) == int(jstats["match_count"])
    _tables_equal(got, want)
    _assert_fresh(_table_tensors(got) + tuple(stats.values()),
                  _table_tensors(tp) + _table_tensors(tb))
