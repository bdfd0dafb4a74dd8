"""The port's Query layer and columnar persistence against the JAX
package's.

Every case of ``tests/test_query_io.py`` runs the same query on the same
numpy tables in both packages (the JAX side under ``jax.jit``) and the
results must be equal: the valid rows of every column with their dtypes,
``num_rows`` and the capacity.  Beyond those: ``sort_by`` with a 16-bit
descending key, ``distinct``, ``top_k``, ``limit``, and files written by
either package loading in the other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radix_sort_tpu import io as jio
from radix_sort_tpu.query import Query as JQuery
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import Query, SortConfig, dtypes as tdt, io as tio
from radix_sort_tpu_torch.table import Table


def both(cols, num_rows=None):
    jt = JTable({k: jnp.asarray(v) for k, v in cols.items()},
                num_rows=num_rows)
    tt = Table({k: tdt.tensor_from_numpy(np.asarray(v), "cpu")
                for k, v in cols.items()}, num_rows=num_rows)
    return jt, tt


def assert_tables_equal(got, want):
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    g, w = got.to_numpy(), want.to_numpy()
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype, (k, g[k].dtype, w[k].dtype)
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def run_both(build, jt, tt):
    """``build(Query)`` collected in each package."""
    return (build(Query(tt)).collect(),
            jax.jit(lambda t: build(JQuery(t)).collect())(jt))


def _cols():
    rng = np.random.default_rng(0)
    return {"k": rng.integers(0, 50, 1000).astype(np.uint32),
            "x": rng.integers(0, 10, 1000).astype(np.int32)}


# ---- the cases of tests/test_query_io.py ----------------------------------

def test_query_filter_groupby_sort_matches_jax():
    jt, tt = both(_cols())
    got, want = run_both(lambda q: q.filter("k", "lt", 25)
                         .group_by("k", n=("count", None), s=("sum", "x"))
                         .sort_by("k"), jt, tt)
    assert_tables_equal(got, want)
    keys, xs = _cols()["k"], _cols()["x"]
    mask = keys < 25
    np.testing.assert_array_equal(got.to_numpy()["n"],
                                  np.bincount(keys[mask])[np.unique(
                                      keys[mask])])
    np.testing.assert_array_equal(
        got.to_numpy()["s"],
        np.bincount(keys[mask], xs[mask])[np.unique(keys[mask])])


def test_query_join_and_with_column_matches_jax():
    jt, tt = both(_cols())
    build = {"k": np.arange(50, dtype=np.uint32),
             "lbl": np.arange(50, dtype=np.int32) * 2}
    jb, tb = both(build)
    q = (Query(tt).with_column("x2", lambda t: t["x"] * 2)
         .join(tb, on="k"))
    got = q.collect()
    want = jax.jit(lambda t, b: JQuery(t).with_column(
        "x2", lambda tbl: tbl["x"] * 2).join(b, on="k").collect())(jt, jb)
    assert_tables_equal(got, want)
    res = got.to_numpy()
    assert np.array_equal(res["x2"], res["x"] * 2)
    assert np.array_equal(res["lbl"], res["k"].astype(np.int32) * 2)
    assert "join" in q.last_stats
    assert int(q.last_stats["join"]["match_count"]) == 1000


def test_query_select_and_filter_mask_matches_jax():
    jt, tt = both(_cols())
    got, want = run_both(lambda q: q.filter_mask(lambda t: (t["x"] % 2) == 0)
                         .select(["x"]), jt, tt)
    assert_tables_equal(got, want)
    assert got.column_names == ("x",)


def test_sort_by_keeps_padding_at_tail_matches_jax():
    jt, tt = both({"k": np.array([5, 1, 9, 77], np.uint32),
                   "v": np.array([50, 10, 90, 770], np.int32)}, num_rows=3)
    got, want = run_both(lambda q: q.sort_by("k"), jt, tt)
    assert_tables_equal(got, want)
    assert np.array_equal(got.to_numpy()["k"], [1, 5, 9])
    assert np.array_equal(got.to_numpy()["v"], [10, 50, 90])


def test_save_load_roundtrip(tmp_path):
    t = Table({"k": tdt.tensor_from_numpy(np.array([3, 1, 2, 9], np.uint32),
                                          "cpu"),
               "v": torch.tensor([1., 2., 3., 4.])}, num_rows=3)
    path = tio.save_table(t, str(tmp_path / "t"))
    assert path.endswith(".npz")
    back = tio.load_table(path, device="cpu")
    assert int(back.num_rows) == 3 and back.capacity == 4
    assert back["k"].dtype == torch.uint32
    # the whole capacity, padding included
    np.testing.assert_array_equal(tdt.tensor_to_numpy(back["k"]),
                                  [3, 1, 2, 9])
    assert torch.equal(back["v"], t["v"])


def test_batch_writer_iter(tmp_path):
    w = tio.BatchWriter(str(tmp_path / "runs"))
    for i in range(3):
        w.write(Table({"a": torch.arange(4, dtype=torch.int32) + i}))
    w.finish()
    batches = list(tio.iter_batches(str(tmp_path / "runs"), device="cpu"))
    assert len(batches) == 3
    assert torch.equal(batches[2]["a"], torch.tensor([2, 3, 4, 5],
                                                     dtype=torch.int32))


def test_multi_key_sort_matches_jax():
    cols = {"a": np.array([2, 1, 2, 1, 2], np.uint32),
            "b": np.array([9, 5, 1, 7, 1], np.int32),
            "v": np.arange(5, dtype=np.int32)}
    jt, tt = both(cols)
    got, want = run_both(lambda q: q.sort_by("a", "b"), jt, tt)
    assert_tables_equal(got, want)
    np.testing.assert_array_equal(got.to_numpy()["v"],
                                  np.lexsort((cols["b"], cols["a"])))


def test_query_sort_by_descending_matches_jax():
    rng = np.random.default_rng(31)
    g = rng.integers(0, 5, 64).astype(np.int32)
    x = rng.integers(-100, 100, 64).astype(np.int32)
    jt, tt = both({"g": g, "x": x}, num_rows=50)
    got, want = run_both(lambda q: q.sort_by("g", "x",
                                             descending=[True, False]),
                         jt, tt)
    assert_tables_equal(got, want)
    order = np.lexsort((x[:50], -g[:50]))
    np.testing.assert_array_equal(got.to_numpy()["g"], g[:50][order])
    got, want = run_both(lambda q: q.sort_by("x", descending=True), jt, tt)
    assert_tables_equal(got, want)
    with pytest.raises(ValueError):
        Query(tt).sort_by("g", "x", descending=[True])


# ---- beyond the JAX tests --------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.uint16], ids=["i16", "u16"])
def test_sort_by_16bit_descending_key(dtype):
    """A descending 16-bit key inverts its image within 16 bits (a bare ~
    would flip the int32 container's upper bits too), and padding rows
    still come last; ties keep their order under the next key."""
    rng = np.random.default_rng(33)
    info = np.iinfo(dtype)
    k = rng.integers(info.min, info.max, 300, endpoint=True).astype(dtype)
    k[::3] = rng.choice(np.array([info.min, 0, 1, info.max], dtype), 100)
    x = rng.integers(0, 4, 300).astype(np.int32)
    row = np.arange(300, dtype=np.int32)
    jt, tt = both({"k": k, "x": x, "row": row}, num_rows=280)
    for desc in ([True, False], [True, True], [False, True]):
        got, want = run_both(lambda q: q.sort_by("k", "x", descending=desc),
                             jt, tt)
        assert_tables_equal(got, want)
        sk = np.where(desc[0], -k[:280].astype(np.int64), k[:280])
        sx = np.where(desc[1], -x[:280], x[:280])
        np.testing.assert_array_equal(got.to_numpy()["row"],
                                      np.lexsort((sx, sk)))


def test_distinct_top_k_limit_match_jax():
    rng = np.random.default_rng(34)
    cols = {"k": rng.integers(0, 40, 900).astype(np.uint32),
            "row": np.arange(900, dtype=np.int32),
            "w": rng.standard_normal(900)}
    jt, tt = both(cols, num_rows=850)
    for build in (lambda q: q.distinct("k"),
                  lambda q: q.distinct("k").limit(7),
                  lambda q: q.top_k("w", 25),
                  lambda q: q.top_k("k", 300, largest=False),
                  lambda q: q.limit(10),
                  lambda q: q.limit(5000),
                  lambda q: q.filter("k", "lt", 3).limit(1000).sort_by(
                      "w", descending=True)):
        got, want = run_both(build, jt, tt)
        assert_tables_equal(got, want)


def test_collect_on_torch_sort_engine_matches():
    jt, tt = both(_cols(), num_rows=990)

    def build(q):
        return (q.filter("x", "gt", 2).group_by("k", n=("count", None))
                .sort_by("n", "k", descending=[True, False]))

    a = build(Query(tt)).collect()
    b = build(Query(tt, SortConfig(engine="torch_sort"))).collect()
    assert_tables_equal(a, b)
    assert_tables_equal(a, jax.jit(lambda t: build(JQuery(t)).collect())(jt))


def _io_cols():
    rng = np.random.default_rng(35)
    return {"u": rng.integers(0, 2**32, 40, dtype=np.uint64).astype(
                np.uint32),
            "w": rng.integers(0, 2**64 - 1, 40, dtype=np.uint64),
            "i": rng.integers(-5, 5, 40).astype(np.int64),
            "f": rng.standard_normal(40).astype(np.float32)}


def test_file_written_by_jax_loads_in_port(tmp_path):
    cols = _io_cols()
    jt, _ = both(cols, num_rows=33)
    path = jio.save_table(jt, str(tmp_path / "j"))
    back = tio.load_table(path, device="cpu")
    assert int(back.num_rows) == 33 and back.capacity == 40
    for k, v in cols.items():
        got = tdt.tensor_to_numpy(back[k])
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)  # padding included


def test_file_written_by_port_loads_in_jax(tmp_path):
    cols = _io_cols()
    _, tt = both(cols, num_rows=33)
    w = tio.BatchWriter(str(tmp_path / "runs"))
    w.write(tt)
    w.write(tt.head(5))
    w.finish()
    batches = list(jio.iter_batches(str(tmp_path / "runs"), device=False))
    assert [int(b.num_rows) for b in batches] == [33, 5]
    assert [b.capacity for b in batches] == [40, 5]
    for k, v in cols.items():
        got = np.asarray(batches[0][k])
        assert got.dtype == v.dtype
        np.testing.assert_array_equal(got, v)
    back = list(tio.iter_batches(str(tmp_path / "runs"), device="cpu"))
    assert_tables_equal(back[1], batches[1])
