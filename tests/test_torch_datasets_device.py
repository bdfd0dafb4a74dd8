"""The port's datasets_device against the contract of the JAX package's
(``radix_sort_tpu/datasets_device.py``), on the CPU: the dtype and the
shape, all-zero ``Zeros``, ``Range`` / ``InvertedRange`` equal to the JAX
twins and to the host datasets, the dtype's extremes planted at both ends
of ``RandomDistributed``, floats in [-1e9, 1e9].  The random bits are the
port's own (a seeded ``torch.Generator``), so they are held to being
deterministic, spread over every bit, and different between seeds, not to
``jax.random``'s values."""

import numpy as np
import pytest
import torch

from radix_sort_tpu import datasets_device as jdd
from radix_sort_tpu_torch import datasets, datasets_device as dd
from radix_sort_tpu_torch import dtypes as tdt

DTYPES = [np.uint32, np.int32, np.uint64, np.int64, np.float32, np.float64]
IDS = ["u32", "i32", "u64", "i64", "f32", "f64"]


def gen(name, dtype, n, seed=0):
    out = dd.generate(name, dtype, n, seed=seed, device="cpu")
    assert out.device.type == "cpu"
    return tdt.tensor_to_numpy(out)


@pytest.mark.parametrize("name", dd.ALL_NAMES)
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_dtype_and_shape(name, dtype):
    for n in (0, 1, 1025):
        out = gen(name, dtype, n)
        assert out.dtype == np.dtype(dtype) and out.shape == (n,)


@pytest.mark.parametrize("name", ["Zeros", "Range", "InvertedRange"])
@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_exact_datasets_match_jax_and_host(name, dtype):
    out = gen(name, dtype, 257)
    np.testing.assert_array_equal(out, np.asarray(jdd.generate(name, dtype,
                                                               257)))
    host = {d.name: d for d in datasets.make_datasets(dtype)}[name]
    np.testing.assert_array_equal(out, host.generate(257))


@pytest.mark.parametrize("dtype", DTYPES, ids=IDS)
def test_random_distributed_plants_extremes(dtype):
    d = np.dtype(dtype)
    out = gen("RandomDistributed", dtype, 4096, seed=1)
    if d.kind == "f":
        assert out[0] == -np.inf and out[-1] == np.inf
        inner = out[1:-1]
        assert np.isfinite(inner).all()
        assert inner.min() >= -1e9 and inner.max() <= 1e9
        assert inner.min() < -9e8 and inner.max() > 9e8  # spread over it
    else:
        info = np.iinfo(d)
        assert out[0] == info.min and out[-1] == info.max
    # Random draws the same bits without the plants
    rnd = gen("Random", dtype, 4096, seed=1)
    np.testing.assert_array_equal(rnd[1:-1], out[1:-1])


@pytest.mark.parametrize("dtype", [np.uint32, np.int64, np.uint64],
                         ids=["u32", "i64", "u64"])
def test_random_bits_cover_every_bit(dtype):
    """Each bit of the word is set in about half the keys: a 64-bit key is
    two 32-bit draws, since torch.randint cannot draw every 64-bit
    pattern in one call."""
    out = gen("Random", dtype, 1 << 14, seed=3)
    width = 8 * out.dtype.itemsize
    u = out.view(f"u{out.dtype.itemsize}")
    ones = np.array([((u >> np.array(b, u.dtype)) & 1).mean()
                     for b in range(width)])
    assert (np.abs(ones - 0.5) < 0.05).all(), ones


def test_seeds_are_deterministic_and_distinct():
    a = gen("Random", np.uint32, 1000, seed=5)
    np.testing.assert_array_equal(a, gen("Random", np.uint32, 1000, seed=5))
    assert not np.array_equal(a, gen("Random", np.uint32, 1000, seed=6))
    outs = [gen(nm, np.uint32, 64) for nm in dd.ALL_NAMES]
    for i in range(len(outs)):
        for j in range(i + 1, len(outs)):
            assert not np.array_equal(outs[i], outs[j])


@pytest.mark.parametrize("dtype", [np.int16, np.uint16], ids=["i16", "u16"])
def test_16bit_keys(dtype):
    info = np.iinfo(dtype)
    out = gen("RandomDistributed", dtype, 3000, seed=2)
    assert out.dtype == np.dtype(dtype)
    assert out[0] == info.min and out[-1] == info.max
    host = {d.name: d for d in datasets.make_datasets(dtype)}
    for name in ("Range", "InvertedRange"):
        np.testing.assert_array_equal(gen(name, dtype, 300),
                                      host[name].generate(300))


def test_unknown_rejected():
    with pytest.raises(ValueError):
        dd.generate("Nope", np.uint32, 8, device="cpu")
    assert dd.ALL_NAMES == jdd.ALL_NAMES


def test_default_device_is_the_card():
    """Without a device argument the data goes to the card: on a machine
    without one that raises, it never falls back to the CPU."""
    if torch.cuda.is_available():
        assert dd.generate("Zeros", np.uint32, 4).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            dd.generate("Range", np.uint32, 4)
