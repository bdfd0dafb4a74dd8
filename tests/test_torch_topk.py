"""The port's top_k / top_k_kv / topk_table against the JAX package's.

Heavy ties and both directions: the selected keys and the payloads must
equal the JAX functions' bit for bit, so the stability contract (ties go
to the earlier row) holds on the port's composite-key selection (small k)
and on its sort path (large k, or 8-byte keys)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.ops import topk as jtopk
from radix_sort_tpu.table import Table as JTable
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import cuda_merge, stream, topk

DTYPES = [np.uint32, np.int32, np.uint64, np.int64, np.float32, np.int16]
IDS = ["u32", "i32", "u64", "i64", "f32", "i16"]


def _tied_keys(dtype, n, seed):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "u":
        return rng.integers(0, 50, n).astype(dtype)
    return rng.integers(-25, 25, n).astype(dtype)


@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("k", [0, 1, 7, 100, 900])  # 900 > n//4: sort path
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_top_k_matches_jax(dtype, k, largest):
    keys = _tied_keys(dtype, 1000, 3)
    want = np.asarray(rst.top_k(jnp.asarray(keys), k, largest=largest))
    got = tdt.tensor_to_numpy(rtt.top_k(tdt.tensor_from_numpy(keys, "cpu"), k,
                                        largest=largest))
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("k", [5, 600])  # both paths
@pytest.mark.parametrize("dtype", [np.uint32, np.int64], ids=["u32", "i64"])
def test_top_k_kv_stable_ties_match_jax(dtype, k, largest):
    rng = np.random.default_rng(7)
    n = 1000
    keys = rng.integers(0, 8, n).astype(dtype)  # massive ties
    pay = {"row": np.arange(n, dtype=np.int32),
           "u": rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32),
           "f": rng.standard_normal(n)}
    jk, jp = rst.top_k_kv(jnp.asarray(keys),
                          {a: jnp.asarray(v) for a, v in pay.items()}, k,
                          largest=largest)
    tk, tp = rtt.top_k_kv(tdt.tensor_from_numpy(keys, "cpu"),
                          {a: tdt.tensor_from_numpy(v, "cpu")
                           for a, v in pay.items()},
                          k, largest=largest)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(tk), np.asarray(jk))
    for a in pay:
        got = tdt.tensor_to_numpy(tp[a])
        assert got.dtype == pay[a].dtype
        np.testing.assert_array_equal(got, np.asarray(jp[a]))
    order = np.argsort(keys if not largest else -keys.astype(np.int64),
                       kind="stable")[:k]
    np.testing.assert_array_equal(tp["row"].numpy(), order)


def test_top_k_under_merge_runs_the_merge_sort(monkeypatch):
    """A key-only selection with k > n/4 under engine="merge" sorts with the
    merge kernels; the small-k path does not sort."""
    calls = []
    real = cuda_merge.merge_sort_bits
    monkeypatch.setattr(cuda_merge, "merge_sort_bits",
                        lambda b: calls.append(b.numel()) or real(b))
    keys = _tied_keys(np.uint32, 3000, 5)
    cfg = rtt.SortConfig(engine="merge")
    for k, largest in ((2000, True), (1500, False), (10, True)):
        want = np.asarray(rst.top_k(jnp.asarray(keys), k, largest=largest))
        got = rtt.top_k(tdt.tensor_from_numpy(keys, "cpu"), k, largest=largest,
                        config=cfg)
        np.testing.assert_array_equal(tdt.tensor_to_numpy(got), want)
    assert calls == [3000, 3000]


@pytest.mark.parametrize("dtype", [np.int16, np.uint16], ids=["i16", "u16"])
def test_top_k_16bit_under_merge_sorts_16_bits(monkeypatch, dtype):
    """16-bit keys under engine="merge" take ``radix`` over their 16 bits
    (2 passes) on the large-k path, as ops/sort.py documents, for both
    directions and for top_k_kv and topk_table alike."""
    merges, radix_bits = [], []
    real_merge, real_radix = cuda_merge.merge_sort_bits, stream.sort_biased
    monkeypatch.setattr(cuda_merge, "merge_sort_bits",
                        lambda b: merges.append(b.numel()) or real_merge(b))
    monkeypatch.setattr(
        stream, "sort_biased",
        lambda b, p, c, t=None: radix_bits.append(t) or real_radix(b, p, c, t))
    keys = _tied_keys(dtype, 3000, 5)
    rows = np.arange(3000, dtype=np.int32)
    cfg = rtt.SortConfig(engine="merge")
    for largest in (True, False):
        want = np.asarray(rst.top_k(jnp.asarray(keys), 2000, largest=largest))
        got = rtt.top_k(tdt.tensor_from_numpy(keys, "cpu"), 2000,
                        largest=largest, config=cfg)
        np.testing.assert_array_equal(tdt.tensor_to_numpy(got), want)
        jk, jr = rst.top_k_kv(jnp.asarray(keys), jnp.asarray(rows), 1500,
                              largest=largest)
        tk, tr = rtt.top_k_kv(tdt.tensor_from_numpy(keys, "cpu"),
                              torch.from_numpy(rows), 1500, largest=largest,
                              config=cfg)
        np.testing.assert_array_equal(tdt.tensor_to_numpy(tk), np.asarray(jk))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        t = convert.table_from_numpy({"k": keys, "r": rows}, num_rows=2500,
                                     device="cpu")
        jt = JTable({"k": jnp.asarray(keys), "r": jnp.asarray(rows)},
                    num_rows=2500)
        g = topk.topk_table(t, "k", 2000, largest=largest,
                            config=cfg).to_numpy()
        w = jtopk.topk_table(jt, "k", 2000, largest=largest).to_numpy()
        for a in ("k", "r"):
            np.testing.assert_array_equal(g[a], w[a])
    assert merges == [] and radix_bits == [16] * 6


def test_top_k_float_total_order():
    keys = np.array([1.5, -np.inf, np.inf, -0.0, 0.0, 2.5, -3.25],
                    np.float32)
    t = torch.from_numpy(keys)
    for largest in (True, False):
        want = np.asarray(rst.top_k(jnp.asarray(keys), 3, largest=largest))
        np.testing.assert_array_equal(
            rtt.top_k(t, 3, largest=largest).numpy().view(np.uint32),
            want.view(np.uint32))


def test_top_k_pytree_payload_and_errors():
    keys = tdt.tensor_from_numpy(np.array([3, 1, 2], np.uint32), "cpu")
    vals = {"a": torch.arange(3, dtype=torch.int32),
            "b": torch.tensor([0.5, 1.5, 2.5])}
    ko, vo = rtt.top_k_kv(keys, vals, 2)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ko), [3, 2])
    np.testing.assert_array_equal(vo["a"].numpy(), [0, 2])
    np.testing.assert_array_equal(vo["b"].numpy(), [0.5, 2.5])
    with pytest.raises(rtt.EngineError):
        rtt.top_k(keys, 4)  # k > capacity
    with pytest.raises(rtt.EngineError):
        rtt.top_k(keys, -1)
    with pytest.raises(rtt.EngineError):
        rtt.top_k_kv(keys, torch.arange(2, dtype=torch.int32), 1)  # ragged


@pytest.mark.parametrize("largest", [True, False], ids=["largest", "smallest"])
@pytest.mark.parametrize("k", [3, 80])
def test_topk_table_padding_loses_matches_jax(k, largest):
    rng = np.random.default_rng(11)
    cap, nrows = 100, 60
    key = rng.integers(0, 10, cap).astype(np.int32)
    key[nrows:] = 127 if largest else -5  # padding holds winning garbage
    cols = {"k": key, "x": np.arange(cap, dtype=np.int32),
            "w": rng.integers(0, 2**64, cap, dtype=np.uint64)}
    jt = JTable({a: jnp.asarray(v) for a, v in cols.items()}, num_rows=nrows)
    want = jtopk.topk_table(jt, "k", k, largest=largest)
    got = topk.topk_table(
        convert.table_from_numpy(cols, num_rows=nrows, device="cpu"), "k", k,
        largest=largest)
    assert got.capacity == want.capacity == k
    assert int(got.num_rows) == int(want.num_rows) == min(k, nrows)
    g, w = got.to_numpy(), want.to_numpy()
    for a in cols:
        np.testing.assert_array_equal(g[a], w[a])


def test_topk_table_smallest_with_real_extreme_keys():
    # real rows that tie with the forced padding score must win
    cap, nrows = 8, 5
    key = np.array([7, 0, 3, 0, 5, 1, 1, 1], np.uint32)
    t = convert.table_from_numpy(
        {"k": key, "r": np.arange(cap, dtype=np.int32)}, num_rows=nrows,
        device="cpu")
    out = topk.topk_table(t, "k", 4, largest=False).to_numpy()
    np.testing.assert_array_equal(out["k"], [0, 0, 3, 5])
    np.testing.assert_array_equal(out["r"], [1, 3, 2, 4])
