"""The port's sort, sort_kv and argsort against the JAX package's.

Every key dtype x every reference distribution, n ~ 3000 (not a tile
multiple): the same numpy keys go through the JAX ``sort_kv`` and the
port's; keys must agree bit for bit and the payload must be the stable
permutation of ``golden.oracle_argsort``.  On this CPU the port's radix
engine runs its kernels' plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu import datasets as jds, golden
from radix_sort_tpu.ops import pallas_stream as ps, scan as jscan
from radix_sort_tpu_torch import convert, dtypes as tdt
from radix_sort_tpu_torch.ops import scan, sort as sort_ops, stream

N = 3001
ALL_DTYPES = [np.uint32, np.int32, np.uint64, np.int64, np.float32,
              np.float64]
IDS = ["u32", "i32", "u64", "i64", "f32", "f64"]
DISTS = [cls.name for cls in jds.ALL_DATASETS]


def _make(dtype, dist, n=N):
    ds = {d.name: d for d in jds.make_datasets(dtype, seed=11)}[dist]
    return ds.generate(n)


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=IDS)
def test_sort_kv_matches_jax(dtype, dist):
    keys = _make(dtype, dist)
    vals = np.arange(keys.size, dtype=np.int32)
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    tk, tv = rtt.sort_kv(tdt.tensor_from_numpy(keys, "cpu"),
                         torch.from_numpy(vals))
    got_k = tdt.tensor_to_numpy(tk)
    assert got_k.dtype == keys.dtype
    np.testing.assert_array_equal(got_k.view(np.uint8),
                                  np.asarray(jk).view(np.uint8))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tv.numpy(), golden.oracle_argsort(keys))


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=IDS)
def test_sort_and_argsort_match_jax(dtype):
    keys = _make(dtype, "RandomDistributed")
    tk = tdt.tensor_from_numpy(keys, "cpu")
    got = tdt.tensor_to_numpy(rtt.sort(tk))
    want = np.asarray(rst.sort(jnp.asarray(keys)))
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    assert golden.validate_bit_exact(got, golden.oracle_sort(keys), N)
    perm = rtt.argsort(tk)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(),
                                  np.asarray(rst.argsort(jnp.asarray(keys))))


@pytest.mark.parametrize("dtype", [np.uint16, np.int16], ids=["u16", "i16"])
def test_16bit_keys_match_jax(dtype):
    """16-bit keys with heavy ties and both extremes: sort, sort_kv and
    argsort give the JAX package's results (two 8-bit passes here)."""
    rng = np.random.default_rng(16)
    info = np.iinfo(dtype)
    keys = rng.choice(np.array([info.min, -1 if info.min else 1, 0, 7,
                                info.max], dtype), N)
    keys[::7] = rng.integers(info.min, info.max + 1, keys[::7].size)
    vals = np.arange(N, dtype=np.int32)
    tk = tdt.tensor_from_numpy(keys, "cpu")
    got = tdt.tensor_to_numpy(rtt.sort(tk))
    assert got.dtype == keys.dtype
    np.testing.assert_array_equal(got, np.asarray(rst.sort(jnp.asarray(keys))))
    jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(vals))
    ok, ov = rtt.sort_kv(tk, torch.from_numpy(vals))
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ok), np.asarray(jk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(rtt.argsort(tk).numpy(),
                                  golden.oracle_argsort(keys))


def test_heavy_ties_are_stable_across_payload_widths():
    """Few distinct keys, payloads of 1, 4 and 8 bytes (bool, f32, u64) in a
    dict pytree: each rides the stable permutation unchanged."""
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 4, 2500).astype(np.int64)
    pay = {"b": rng.integers(0, 2, 2500).astype(bool),
           "f": rng.standard_normal(2500).astype(np.float32),
           "u": rng.integers(0, 2**64, 2500, dtype=np.uint64)}
    jk, jp = rst.sort_kv(jnp.asarray(keys),
                         {k: jnp.asarray(v) for k, v in pay.items()})
    tk, tp = rtt.sort_kv(torch.from_numpy(keys),
                         {k: tdt.tensor_from_numpy(v, "cpu")
                          for k, v in pay.items()})
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for k in pay:
        got = tdt.tensor_to_numpy(tp[k])
        assert got.dtype == pay[k].dtype
        np.testing.assert_array_equal(got, np.asarray(jp[k]))


def test_tuple_payload_and_engines_agree():
    keys = _make(np.uint32, "Random")
    k = tdt.tensor_from_numpy(keys, "cpu")
    a = torch.arange(N, dtype=torch.int32)
    r_k, (r_a, r_b) = rtt.sort_kv(k, (a, a * 2), engine="radix")
    t_k, (t_a, t_b) = rtt.sort_kv(k, (a, a * 2), engine="torch_sort")
    assert torch.equal(r_k.view(torch.int32), t_k.view(torch.int32))
    assert torch.equal(r_a, t_a) and torch.equal(r_b, t_b)
    cfg = rtt.SortConfig(bits_per_pass=4, tile_elems=2048, threads_per_cta=128)
    c_k, c_a = rtt.sort_kv(k, a, config=cfg)
    assert torch.equal(c_k.view(torch.int32), r_k.view(torch.int32))
    assert torch.equal(c_a, r_a)


@pytest.mark.parametrize("engine", ["no_such_engine"])
def test_unported_engines_raise(engine):
    with pytest.raises(rtt.EngineError):
        rtt.sort(torch.arange(5, dtype=torch.int32), engine=engine)


JAX_ENGINE_NAMES = ["pallas", "pallas_stream", "xla_radix", "xla_sort"]


def _tied_keys(n=1000, high=64):
    rng = np.random.default_rng(40)
    keys = rng.integers(0, high, n).astype(np.uint32)
    keys[:2] = (0, high - 1)
    return keys


@pytest.mark.parametrize("engine", JAX_ENGINE_NAMES)
def test_jax_engine_names_match_jax(engine):
    """sort_kv, sort and argsort under each JAX engine name give the JAX
    package's results under that engine: heavy ties, a stable payload.

    For ``pallas_stream`` the keys lie below 2^4 and the JAX side runs the
    engine's kernels (``pallas_stream.sort_planes``) over those 4 bits at
    radix 4: its full-width passes take minutes to interpret on the CPU,
    and the passes above a key's width leave the order as it is."""
    keys = _tied_keys(high=16 if engine == "pallas_stream" else 64)
    vals = np.arange(keys.size, dtype=np.int32)
    if engine == "pallas_stream":
        jk, (jv,) = ps.sort_planes(jnp.asarray(keys), (jnp.asarray(vals),),
                                   radix=4, total_bits=4)
        jsorted = jk
    else:
        jk, jv = rst.sort_kv(jnp.asarray(keys), jnp.asarray(vals),
                             engine=engine)
        jsorted = rst.sort(jnp.asarray(keys), engine=engine)
    tk = tdt.tensor_from_numpy(keys, "cpu")
    ok, ov = rtt.sort_kv(tk, torch.from_numpy(vals), engine=engine)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ok), np.asarray(jk))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ov.numpy(), golden.oracle_argsort(keys))
    np.testing.assert_array_equal(
        tdt.tensor_to_numpy(rtt.sort(tk, engine=engine)), np.asarray(jsorted))
    np.testing.assert_array_equal(rtt.argsort(tk, engine=engine).numpy(),
                                  np.asarray(jv))


@pytest.mark.parametrize("engine", JAX_ENGINE_NAMES + ["pallas_merge"])
def test_jax_engine_names_map_to_port_engines(engine, monkeypatch):
    """The dispatch and convert share one table; a converted JAX config
    sorts, and names the engine that does the work."""
    cfg = convert.sort_config_from_fields(
        dataclasses.asdict(rst.SortConfig(engine=engine)))
    assert cfg.engine == sort_ops.JAX_ENGINES[engine]
    assert convert.ENGINE_NAMES is sort_ops.JAX_ENGINES
    assert sort_ops._dispatch_engine(engine) == cfg.engine
    used = []
    monkeypatch.setattr(sort_ops, "_torch_sort_engine",
                        lambda k, p, real=sort_ops._torch_sort_engine:
                        used.append("torch_sort") or real(k, p))
    keys = tdt.tensor_from_numpy(_tied_keys(), "cpu")
    want = np.sort(_tied_keys())
    for c in (cfg, rtt.SortConfig(engine=engine)):
        np.testing.assert_array_equal(
            tdt.tensor_to_numpy(rtt.sort(keys, config=c)), want)
    assert used == (["torch_sort"] * 2 if engine == "xla_sort" else [])


@pytest.mark.parametrize("engine", ["xla", "pallas", "torch", "kernel"])
def test_exclusive_scan_engine_names_match_jax(engine):
    x = np.random.default_rng(41).integers(-2**31, 2**31, 3001).astype(
        np.int32)
    jname = {"torch": "xla", "kernel": "pallas"}.get(engine, engine)
    want = np.asarray(jscan.exclusive_scan(jnp.asarray(x), engine=jname))
    got = scan.exclusive_scan(torch.from_numpy(x), engine=engine).numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        scan.exclusive_scan(torch.from_numpy(x), engine="nope")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", JAX_ENGINE_NAMES)
def test_cuda_jax_engine_names_launch_the_kernels(engine):
    """On the card pallas, pallas_stream and xla_radix launch the radix
    kernels (xla_radix is not the plain version there); xla_sort is
    torch.sort and launches none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from radix_sort_tpu_torch.ops import cuda_radix

    keys = np.random.default_rng(42).integers(0, 2**32, 1 << 20,
                                              dtype=np.uint64).astype(
                                                  np.uint32)
    vals = np.arange(keys.size, dtype=np.int32)
    cuda_radix.reset_launch_counts()
    ok, ov = rtt.sort_kv(tdt.tensor_from_numpy(keys, "cuda"),
                         torch.from_numpy(vals).cuda(), engine=engine)
    torch.cuda.synchronize()
    counts = cuda_radix.launch_counts()
    ran = counts["pass_histograms"] > 0 and counts["onesweep_pass"] > 0
    assert ran == (engine != "xla_sort"), counts
    order = golden.oracle_argsort(keys)
    np.testing.assert_array_equal(ov.cpu().numpy(), order)
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ok), keys[order])


def test_bad_shapes_raise():
    with pytest.raises(rtt.EngineError):
        rtt.sort(torch.zeros((2, 2), dtype=torch.int32))
    with pytest.raises(rtt.EngineError):
        rtt.sort_kv(torch.zeros(4, dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32))


def test_empty_and_single():
    for n in (0, 1):
        k = torch.arange(n, dtype=torch.int64)
        ko, vo = rtt.sort_kv(k, k.to(torch.int32))
        assert ko.shape == (n,) and vo.shape == (n,)


def test_sort_planes_matches_pallas_stream():
    """The multi-plane LSD loop vs pallas_stream.sort_planes: keys < 2^4
    at radix 4 take two passes, so the interpreted TPU kernel stays quick;
    n = 1280 is not a tile multiple on either side."""
    rng = np.random.default_rng(21)
    n = 1280
    keys = rng.integers(0, 16, n).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    jk, (ja, jb) = ps.sort_planes(jnp.asarray(keys), (
        jnp.asarray(vals), jnp.asarray(vals * 3)), radix=4, total_bits=4)
    tk, (ta, tb) = stream.sort_planes(
        torch.from_numpy(keys.view(np.int32)),
        (torch.from_numpy(vals), torch.from_numpy(vals * 3)), radix=4,
        tile=1024 * 2, total_bits=4)
    np.testing.assert_array_equal(tk.numpy().view(np.uint32), np.asarray(jk))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_u64_word_planes_roundtrip():
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 2**64, 777, dtype=np.uint64)
    bits = tdt.to_sortable(tdt.tensor_from_numpy(keys, "cpu"))
    words = stream.key_word_planes(bits)
    assert len(words) == 2 and all(w.dtype == torch.int32 for w in words)
    np.testing.assert_array_equal(words[0].numpy().view(np.uint32),
                                  (keys & 0xFFFFFFFF).astype(np.uint32))
    np.testing.assert_array_equal(words[1].numpy().view(np.uint32),
                                  (keys >> np.uint64(32)).astype(np.uint32))
    assert torch.equal(stream.join_key_word_planes(words, torch.int64), bits)
