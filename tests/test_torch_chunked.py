"""The port's range-chunked sort (radix_sort_tpu_torch/ops/chunked_sort.py)
against the JAX package's: the same splitters and chunk destinations, the
same sorted keys and payloads, bit for bit.

The JAX side runs as tests/test_chunked_sort.py runs it (jit, its Pallas
partition in interpret mode, ``min_n=0``, 4 chunks, 256 samples); the
port's side runs the plain versions of the radix kernels on the CPU.  The
port has no chunk capacity, so the JAX overflow fallback's input must
simply give the JAX result."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.ops import chunked_sort as jcs, sort as jsort
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import chunked_sort as cs, sort as sort_ops
from radix_sort_tpu_torch.ops import stream

SMALL = {"min_n": 0, "k_chunks": 4, "samples": 256}


def _jax(keys_u, payloads=(), **kw):
    kw = {**SMALL, **kw}
    return jax.jit(lambda k, p: jcs.sort_chunked_biased(k, p, **kw))(
        jnp.asarray(keys_u), tuple(jnp.asarray(p) for p in payloads))


def _port(keys_u, payloads=(), **kw):
    kw = {**SMALL, **kw}
    bits = tdt.to_sortable(tdt.tensor_from_numpy(keys_u, "cpu"))
    ko, po = cs.sort_chunked_biased(
        bits, tuple(torch.from_numpy(p) for p in payloads), **kw)
    return (tdt.tensor_to_numpy(tdt.from_sortable(ko, keys_u.dtype)),
            tuple(p.numpy() for p in po))


def _both(keys, payloads=(), **kw):
    jk, jp = _jax(keys, payloads, **kw)
    pk, pp = _port(keys, payloads, **kw)
    np.testing.assert_array_equal(pk, np.asarray(jk))
    for a, b in zip(pp, jp):
        np.testing.assert_array_equal(a, np.asarray(b))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(pk, keys[order])
    for a, p in zip(pp, payloads):
        np.testing.assert_array_equal(a, p[order])
    return pk, pp


def test_chunk_destinations_monotone_and_in_range():
    rng = np.random.default_rng(40)
    keys = rng.integers(0, 50, 4096).astype(np.uint32)
    spl = np.array([10, 20, 20, 40], np.uint32)  # a duplicated splitter
    dest = cs._chunk_destinations(
        torch.from_numpy(keys.view(np.int32)),
        torch.from_numpy(spl.view(np.int32)), 5).numpy()
    want = np.asarray(jcs._chunk_destinations(jnp.asarray(keys),
                                              jnp.asarray(spl), 5))
    np.testing.assert_array_equal(dest, want)
    assert dest.min() >= 0 and dest.max() <= 4
    order = np.argsort(keys, kind="stable")
    assert np.all(np.diff(dest[order]) >= 0)  # monotone in (key, position)
    assert len(np.unique(dest[keys == 20])) > 1  # ties spread


@pytest.mark.parametrize("dtype", ["u32", "u64"])
def test_chunk_destinations_match_jax_full_range(dtype):
    """Keys and splitters at and above 2^31 (2^63), ties on a splitter: the
    binary searches on the signed containers count as the JAX unsigned
    compares do."""
    rng = np.random.default_rng(41)
    n, K = 8192, 16
    if dtype == "u64":
        keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    else:
        keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    spl = np.sort(keys[rng.choice(n, K - 1, replace=False)])
    keys[rng.random(n) < 0.3] = spl[K // 2]
    want = np.asarray(jcs._chunk_destinations(jnp.asarray(keys),
                                              jnp.asarray(spl), K))
    bits = tdt.to_sortable(tdt.tensor_from_numpy(keys, "cpu"))
    sb = tdt.to_sortable(tdt.tensor_from_numpy(spl, "cpu"))
    np.testing.assert_array_equal(cs._chunk_destinations(bits, sb, K).numpy(),
                                  want)


def test_tie_spread_is_int64_at_2_30():
    """At n = 2^30 with 1024 chunks the JAX int32 product (pos >> 8) *
    width wraps; the port's spread, on the last positions, is the exact
    value, and lies in the tied range."""
    n = 1 << 30
    pos = torch.arange(n - 4096, n, dtype=torch.int64)
    lo = torch.zeros_like(pos)
    width = torch.full_like(pos, 1024)
    got = cs._tie_spread(pos, n, lo, width).numpy()
    exact = ((pos.numpy() >> 8) * 1024) // (n >> 8)  # python-int exact
    np.testing.assert_array_equal(got, exact)
    assert got.min() >= 0 and got.max() <= 1023
    wrapped = ((pos.numpy().astype(np.int32) >> 8) * np.int32(1024)
               ).astype(np.int32) // np.int32(n >> 8)
    assert (wrapped != exact).any()  # what int32 would have given
    # below the wrap the values are the JAX ones
    small = torch.arange(0, 1 << 20, 997)
    np.testing.assert_array_equal(
        cs._tie_spread(small, 1 << 20, torch.zeros_like(small),
                       torch.full_like(small, 16)).numpy(),
        ((small.numpy().astype(np.int32) >> 8) * 16) // ((1 << 20) >> 8))


def test_chunked_kv_stable_matches_oracle():
    rng = np.random.default_rng(41)
    keys = rng.integers(0, 300, 4096).astype(np.uint32)
    _both(keys, (np.arange(4096, dtype=np.int32),))


def test_chunked_zeros_balances_without_overflow():
    """All-equal keys: the position-monotone spread balances the chunks,
    and the payload comes out as iota."""
    n = 4096
    keys = np.zeros(n, np.uint32)
    bits = torch.zeros(n, dtype=torch.int32)
    spl = cs._order_stat_splitters(bits[::16][:256], 4)
    counts = np.bincount(cs._chunk_destinations(bits, spl, 4).numpy(),
                         minlength=4)
    assert counts.max() <= int(1.30 * n / 4) + 256
    _, (vo,) = _both(keys, (np.arange(n, dtype=np.int32),))
    np.testing.assert_array_equal(vo, np.arange(n))


def test_chunked_overflow_falls_back_correct():
    """slack=0.30 overflows a JAX chunk (its lax.cond fallback sorts); the
    port has no capacity, and gives the same stable result."""
    rng = np.random.default_rng(42)
    n = 4096
    keys = np.concatenate([np.full(n // 2, 7, np.uint32),
                           rng.integers(0, 2**32, n // 2, dtype=np.uint32)])
    _both(keys, (np.arange(n, dtype=np.int32),), slack=0.30)


def test_chunked_key_only_u32():
    rng = np.random.default_rng(43)
    keys = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    _both(keys)


def test_chunked_u64_kv():
    rng = np.random.default_rng(44)
    keys = rng.integers(0, 2**63, 4096).astype(np.uint64)
    keys[:1024] = keys[0]
    keys[1024:1100] = np.uint64(2**64 - 1)  # full range, the top word set
    _both(keys, (np.arange(4096, dtype=np.int32),))


def test_engine_chunked_public_api_small_n_plain_path():
    """Below min_n the engine is one radix sort: the JAX result still."""
    rng = np.random.default_rng(45)
    keys = rng.integers(0, 1000, 8192).astype(np.int32)
    vals = np.arange(8192, dtype=np.int32)
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                         engine="chunked")
    ko, vo = rtt.sort_kv(torch.from_numpy(keys), torch.from_numpy(vals),
                         engine="chunked")
    np.testing.assert_array_equal(ko.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vo.numpy(), np.asarray(jv))


def test_engine_chunked_at_production_size_partitions_with_stream_pass(
        monkeypatch):
    """sort(engine="chunked") at 2^18 rows (the default min_n) chunks: one
    stream.partition_planes over 8 chunks, never the torch.sort engine;
    the result is the stable sort, keys across 2^31 included."""
    calls = []
    real = stream.partition_planes
    monkeypatch.setattr(stream, "partition_planes",
                        lambda ids, planes, nb, *a, **kw:
                        calls.append(nb) or real(ids, planes, nb, *a, **kw))
    monkeypatch.setattr(sort_ops, "_torch_sort_engine",
                        lambda *a: pytest.fail("torch.sort engine ran"))
    n = 1 << 18
    keys = np.random.default_rng(46).integers(0, 2**32, n, dtype=np.uint64
                                              ).astype(np.uint32)
    keys[::3] = keys[7]
    vals = np.arange(n, dtype=np.int32)
    ko, vo = rtt.sort_kv(tdt.tensor_from_numpy(keys, "cpu"),
                         torch.from_numpy(vals), engine="chunked")
    assert calls == [8]
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(vo.numpy(), order)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ko), keys[order])


def test_chunked_more_than_256_chunks_takes_two_passes():
    rng = np.random.default_rng(47)
    n = 300 * 256
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    pk, (pv,) = _port(keys, (vals,), k_chunks=300, samples=4096)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(pk, keys[order])
    np.testing.assert_array_equal(pv, order)


def test_chunked_k_chunks_over_1024_raises():
    with pytest.raises(ValueError):
        cs.sort_chunked_biased(torch.zeros(8, dtype=torch.int32),
                               k_chunks=1025)
    with pytest.raises(ValueError):
        jcs.sort_chunked_biased(jnp.zeros(8, jnp.uint32), k_chunks=1025)


def test_chunked_leaves_its_inputs_unchanged():
    """One chunk filled by every row hands the partition's inputs back;
    the in-place chunk sorts must not write into the caller's tensors."""
    n = 4096
    keys = torch.full((n,), 3, dtype=torch.int32)
    keys[::2] = 5
    vals = torch.arange(n, dtype=torch.int32)
    before = (keys.clone(), vals.clone())
    cs.sort_chunked_biased(keys, (vals,), **SMALL)
    assert torch.equal(keys, before[0]) and torch.equal(vals, before[1])


def test_auto_never_picks_chunked(monkeypatch):
    assert sort_ops._dispatch_engine("auto") == "radix"
    assert jsort._dispatch_engine("auto", 1 << 30) != "chunked"
    monkeypatch.setattr(cs, "sort_chunked_biased",
                        lambda *a, **kw: pytest.fail("chunked ran"))
    keys = torch.arange(1 << 18, 0, -1, dtype=torch.int32)
    assert torch.equal(rtt.sort(keys), torch.arange(1, (1 << 18) + 1,
                                                    dtype=torch.int32))


def test_chunked_engine_name_maps_through_convert():
    cfg = convert.sort_config_from_fields(
        dataclasses.asdict(rst.SortConfig(engine="chunked")))
    assert cfg.engine == "chunked" == sort_ops._dispatch_engine("chunked")
    keys = np.random.default_rng(48).integers(0, 50, 5000).astype(np.uint32)
    got = rtt.sort(tdt.tensor_from_numpy(keys, "cpu"), config=cfg)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(got), np.sort(keys))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_cuda_chunked_engine_launches_the_kernels(dtype):
    """On the card: sort_kv(engine="chunked") at 2^20 launches the
    partition pass and the chunk sorts' passes, and is the stable sort."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from radix_sort_tpu_torch.ops import cuda_radix

    n = 1 << 20
    keys = np.random.default_rng(49).integers(0, 2**63, n).astype(dtype)
    keys[::5] = keys[1]
    vals = np.arange(n, dtype=np.int32)
    cuda_radix.reset_launch_counts()
    ko, vo = rtt.sort_kv(tdt.tensor_from_numpy(keys, "cuda"),
                         torch.from_numpy(vals).cuda(), engine="chunked")
    torch.cuda.synchronize()
    counts = cuda_radix.launch_counts()
    assert counts["pass_histograms"] >= 9 and counts["onesweep_pass"] >= 9
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(vo.cpu().numpy(), order)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ko), keys[order])
