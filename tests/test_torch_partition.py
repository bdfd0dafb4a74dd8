"""The port's partition and scan operators against the JAX package's.

``method="stream"`` is the radix kernels' stable pass (their plain versions
on this CPU); each method is called by name, never through "auto".  Bucket
ids stay inside [0, num_buckets), the contract of the stream method."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radix_sort_tpu.ops import pallas_stream as ps
from radix_sort_tpu.ops import partition as jpart, scan as jscan
from radix_sort_tpu_torch import dtypes as tdt
from radix_sort_tpu_torch.ops import partition, scan, stream


def test_partition_planes_matches_pallas_stream():
    """One binary pass over two planes, n = 4000 (no tile multiple on
    either side), against the interpreted TPU kernel; the counts must equal
    the JAX counts although the port pads nothing."""
    rng = np.random.default_rng(22)
    n = 4000
    ids = rng.integers(0, 2, n).astype(np.int32)
    a = np.arange(n, dtype=np.int32)
    b = rng.integers(-2**31, 2**31, n).astype(np.int32)
    jo, jc = ps.partition_planes(jnp.asarray(ids),
                                 (jnp.asarray(a), jnp.asarray(b)), 2)
    to, tc = stream.partition_planes(
        torch.from_numpy(ids), (torch.from_numpy(a), torch.from_numpy(b)), 2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for x, y in zip(to, jo):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _mixed_arrays(rng, n):
    return {"f": rng.standard_normal(n).astype(np.float32),
            "i": np.arange(n, dtype=np.int32),
            "u": rng.integers(0, 2**32, n, dtype=np.uint32),
            "l": rng.integers(-2**62, 2**62, n).astype(np.int64)}


@pytest.mark.parametrize("method", ["stream", "rank", "sort"])
@pytest.mark.parametrize("nb", [2, 5, 16, 300])
def test_stable_partition_matches_jax_sort(method, nb):
    rng = np.random.default_rng(nb)
    n = 3000
    ids = rng.integers(0, nb, n).astype(np.int32)
    arrs = _mixed_arrays(rng, n)
    names = sorted(arrs)
    jout, jcnt, jst = jpart.stable_partition(
        jnp.asarray(ids), tuple(jnp.asarray(arrs[k]) for k in names), nb,
        method="sort")
    tout, tcnt, tst = partition.stable_partition(
        torch.from_numpy(ids),
        tuple(tdt.tensor_from_numpy(arrs[k], "cpu") for k in names), nb,
        method=method)
    assert tcnt.dtype == torch.int32 and tst.dtype == torch.int32
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    for k, x, y in zip(names, tout, jout):
        got = tdt.tensor_to_numpy(x)
        assert got.dtype == arrs[k].dtype
        np.testing.assert_array_equal(got, np.asarray(y))


def test_sort_method_orders_out_of_range_ids_by_value():
    ids = np.array([3, 7, 0, -1, 2, 7, 1], np.int32)
    vals = np.arange(7, dtype=np.int32)
    jo, jc, js = jpart.stable_partition(jnp.asarray(ids),
                                        (jnp.asarray(vals),), 4)
    to, tc, ts = partition.stable_partition(torch.from_numpy(ids),
                                            (torch.from_numpy(vals),), 4)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("method", ["auto", "stream", "sort"])
def test_compact_mask_matches_jax(method):
    rng = np.random.default_rng(8)
    n = 2500
    mask = rng.random(n) < 0.3
    arrs = _mixed_arrays(rng, n)
    names = sorted(arrs)
    jout, jk = jpart.compact_mask(jnp.asarray(mask),
                                  tuple(jnp.asarray(arrs[k]) for k in names))
    tout, tk = partition.compact_mask(
        torch.from_numpy(mask),
        tuple(tdt.tensor_from_numpy(arrs[k], "cpu") for k in names),
        method=method)
    assert tk.dtype == torch.int32 and tk.ndim == 0
    assert int(tk) == int(jk)
    for x, y in zip(tout, jout):
        np.testing.assert_array_equal(tdt.tensor_to_numpy(x), np.asarray(y))


def test_compact_prefix_slots_matches_jax():
    rng = np.random.default_rng(9)
    S, L = 5, 40
    counts = np.array([3, 0, 40, 17, 1], np.int32)
    a = rng.integers(0, 1000, S * L).astype(np.int32)
    u = rng.integers(0, 2**32, S * L, dtype=np.uint32)
    (ja, ju), jt = jpart.compact_prefix_slots(
        (jnp.asarray(a), jnp.asarray(u)), jnp.asarray(counts), L)
    (ta, tu), tt = partition.compact_prefix_slots(
        (torch.from_numpy(a), tdt.tensor_from_numpy(u, "cpu")),
        torch.from_numpy(counts), L)
    total = int(jt)
    assert int(tt) == total
    np.testing.assert_array_equal(ta.numpy()[:total], np.asarray(ja)[:total])
    np.testing.assert_array_equal(tdt.tensor_to_numpy(tu)[:total],
                                  np.asarray(ju)[:total])


def test_radix_partition_matches_jax():
    rng = np.random.default_rng(10)
    keys = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    vals = np.arange(2000, dtype=np.int32)
    jo, jc, _ = jpart.radix_partition(jnp.asarray(keys),
                                      (jnp.asarray(vals),), 4, shift=12)
    bits = tdt.to_sortable(tdt.tensor_from_numpy(keys, "cpu"))
    for method in ("sort", "stream"):
        to, tc, _ = partition.radix_partition(bits, (torch.from_numpy(vals),),
                                              4, shift=12, method=method)
        np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_partition_of_nothing():
    out, cnt, st = partition.stable_partition(
        torch.zeros(0, dtype=torch.int32), (torch.zeros(0),), 3,
        method="stream")
    assert out[0].shape == (0,) and cnt.tolist() == [0, 0, 0]
    with pytest.raises(ValueError):
        partition.stable_partition(torch.zeros(1, dtype=torch.int32), (), 2,
                                   method="bogus")


@pytest.mark.parametrize("engine", ["torch", "kernel"])
def test_exclusive_scan_matches_jax(engine):
    rng = np.random.default_rng(12)
    x = rng.integers(-50, 100, 3333).astype(np.int32)
    want = np.asarray(jscan.exclusive_scan(jnp.asarray(x)))
    got = scan.exclusive_scan(torch.from_numpy(x), engine=engine)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        scan.inclusive_scan(torch.from_numpy(x)).numpy(),
        np.asarray(jscan.inclusive_scan(jnp.asarray(x))))


def test_segment_scans_match_jax():
    rng = np.random.default_rng(13)
    keys = np.sort(rng.integers(0, 40, 1000)).astype(np.int32)
    x = rng.integers(0, 9, 1000).astype(np.int32)
    j_new, j_seg = jscan.segment_boundaries(jnp.asarray(keys))
    t_new, t_seg = scan.segment_boundaries(torch.from_numpy(keys))
    np.testing.assert_array_equal(t_new.numpy(), np.asarray(j_new))
    np.testing.assert_array_equal(t_seg.numpy(), np.asarray(j_seg))
    want = np.asarray(jscan.segmented_exclusive_scan(jnp.asarray(x), j_seg))
    got = scan.segmented_exclusive_scan(torch.from_numpy(x), t_seg)
    np.testing.assert_array_equal(got.numpy(), want)


def test_last_marked_index():
    rng = np.random.default_rng(14)
    mark = rng.random(500) < 0.2
    mark[0] = True
    want = np.maximum.accumulate(np.where(mark, np.arange(500), 0))
    got = scan.last_marked_index(torch.from_numpy(mark))
    np.testing.assert_array_equal(got.numpy(), want)
