"""The port's merge-sort kernels and engine against the JAX package's.

On this CPU the wrappers of ops/cuda_merge.py run their plain torch
versions (the tensors lie on the CPU) and the JAX kernels run in interpret
mode, as tests/test_pallas_merge.py runs them.  Everything is compared bit
for bit.  The tests marked ``cuda`` hold each CUDA kernel against its plain
version on the card and skip without one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu import golden
from radix_sort_tpu.ops import pallas_merge as pm
from radix_sort_tpu_torch import dtypes as tdt
from radix_sort_tpu_torch.ops import cuda_merge as cm

TILE = cm.TILE
assert TILE == pm.TILE


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(kind: str, n: int, seed: int = 0) -> np.ndarray:
    """int32 keys in the sign-flipped domain of the merge kernels."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        x = rng.integers(-2**31, 2**31, n).astype(np.int32)
        x[:3] = (np.iinfo(np.int32).max, np.iinfo(np.int32).min, 0)
        return x
    if kind == "ties":
        return rng.integers(0, 4, n).astype(np.int32)
    if kind in ("sorted", "reversed"):
        x = np.sort(rng.integers(-2**31, 2**31, n).astype(np.int32))
        return x if kind == "sorted" else x[::-1].copy()
    if kind == "disjoint":
        # tile i holds keys of [i, i + 1) * 2^17 - 2^30, shuffled: after any
        # run sort every key of run A lies below every key of run B, so each
        # output tile takes one whole window (la is 0 or TILE)
        tile = np.arange(n, dtype=np.int64) // TILE
        return (tile * 2**17 - 2**30
                + rng.integers(0, 2**17, n)).astype(np.int32)
    return np.full(n, 7, np.int32)


def _runs_sorted(x: np.ndarray, run: int) -> np.ndarray:
    return np.sort(x.reshape(-1, run), axis=1).reshape(-1)


@pytest.mark.parametrize("kind", ["random", "sorted", "reversed",
                                  "disjoint"])
def test_tile_sort_matches_pallas(kind):
    x = _keys(kind, 2 * TILE)
    want = np.asarray(jax.jit(pm.tile_sort)(jnp.asarray(x)))
    got = cm.tile_sort(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_disjoint_keys_take_whole_windows():
    """The disjoint kind reaches the kernels' one-empty-window case."""
    for level in range(3):
        x = _runs_sorted(_keys("disjoint", 8 * TILE, level), TILE << level)
        la = cm.level_splits_plain(torch.from_numpy(x), level)[2]
        assert set(la.tolist()) == {0, TILE}


@pytest.mark.parametrize("kind", ["random", "ties", "equal", "sorted",
                                  "reversed", "disjoint"])
def test_level_splits_match_pallas(kind):
    """8 tiles, levels 0-2: the merge-path splits (ties take from A, the
    last tile of a pair takes the rest of A) equal _level_splits'."""
    for level in range(3):
        x = _runs_sorted(_keys(kind, 8 * TILE, level), TILE << level)
        want = pm._level_splits(jnp.asarray(x), level, 8)
        got = cm.level_splits_plain(torch.from_numpy(x), level)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["random", "ties", "sorted", "reversed",
                                  "disjoint"])
@pytest.mark.parametrize("level", [0, 1])
def test_merge_level_matches_pallas(kind, level):
    """4 tiles: fed the JAX splits, merge_level_plain gives the Pallas
    kernel's output; merge_level finds the same splits itself."""
    x = _runs_sorted(_keys(kind, 4 * TILE, level + 5), TILE << level)
    jx = jnp.asarray(x)
    splits = pm._level_splits(jx, level, 4)
    want = np.asarray(jax.jit(pm.merge_level)(jx, *splits))
    tx = torch.from_numpy(x)
    tsplits = tuple(torch.from_numpy(np.array(s)) for s in splits)
    np.testing.assert_array_equal(cm.merge_level_plain(tx, *tsplits).numpy(),
                                  want)
    got, got_splits = cm.merge_level(tx, level, with_splits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    for g, w in zip(got_splits, tsplits):
        assert torch.equal(g, w)
    assert cm.merge_level(tx, level)[1] is None


@pytest.mark.parametrize("n", [0, 5000, TILE, 2 * TILE + 13,
                               8 * TILE - 777])
def test_merge_engine_matches_jax(n):
    """u32/i32/f32 key-only sorts under the port's "merge" engine equal the
    JAX "pallas_merge" engine's (and merge_sort_u32's) bit for bit."""
    rng = np.random.default_rng(n)
    u = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    f = rng.standard_normal(n).astype(np.float32)
    f[:4] = (np.inf, -np.inf, -0.0, 0.0)[:n]
    if n:
        np.testing.assert_array_equal(
            np.asarray(pm.merge_sort_u32(jnp.asarray(u), n)), np.sort(u))
    for keys in (u, u.view(np.int32), f):
        want = np.asarray(rst.sort(jnp.asarray(keys), engine="pallas_merge"))
        got = tdt.tensor_to_numpy(rtt.sort(tdt.tensor_from_numpy(keys, "cpu"),
                                           engine="merge"))
        assert got.dtype == keys.dtype
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("n", [2 * TILE + 13, 8 * TILE - 777])
def test_merge_engine_extreme_keys(n):
    """Real keys equal to the sentinel (0xFFFFFFFF → INT32_MAX), all-zero
    keys, and a mix of both with the padding tail."""
    rng = np.random.default_rng(1)
    mixed = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    mixed[rng.integers(0, n, n // 3)] = 0xFFFFFFFF
    mixed[rng.integers(0, n, n // 3)] = 0
    for keys in (np.full(n, 0xFFFFFFFF, np.uint32), np.zeros(n, np.uint32),
                 mixed):
        want = np.asarray(rst.sort(jnp.asarray(keys), engine="pallas_merge"))
        got = tdt.tensor_to_numpy(rtt.sort(tdt.tensor_from_numpy(keys, "cpu"),
                                           engine="merge"))
        np.testing.assert_array_equal(got, want)


def test_merge_engine_dispatch(monkeypatch):
    """Key-only 32-bit sorts take the merge sort; payloads (sort_kv,
    argsort), 64-bit and 16-bit keys take the radix passes and give the
    JAX engine's stable results."""
    calls = []
    real = cm.merge_sort_bits
    monkeypatch.setattr(cm, "merge_sort_bits",
                        lambda b: calls.append(b.numel()) or real(b))
    rng = np.random.default_rng(3)
    n = 3001
    k32 = rng.integers(0, 8, n).astype(np.uint32)
    vals = np.arange(n, dtype=np.int32)
    rtt.sort(tdt.tensor_from_numpy(k32, "cpu"), engine="merge")
    assert calls == [n]
    jk, jv = rst.sort_kv(jnp.asarray(k32), jnp.asarray(vals),
                         engine="pallas_merge")
    tk, tv = rtt.sort_kv(tdt.tensor_from_numpy(k32, "cpu"),
                         torch.from_numpy(vals), engine="merge")
    np.testing.assert_array_equal(tdt.tensor_to_numpy(tk), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(
        rtt.argsort(tdt.tensor_from_numpy(k32, "cpu"), engine="merge").numpy(),
        golden.oracle_argsort(k32))
    for keys in (rng.integers(0, 2**64, n, dtype=np.uint64),
                 rng.integers(-2**15, 2**15, n).astype(np.int16)):
        want = np.asarray(rst.sort(jnp.asarray(keys), engine="pallas_merge"))
        got = tdt.tensor_to_numpy(rtt.sort(tdt.tensor_from_numpy(keys, "cpu"),
                                           engine="merge"))
        np.testing.assert_array_equal(got, want)
    assert calls == [n]


def test_cpu_tensors_launch_no_merge_kernel():
    cm.reset_launch_counts()
    x = torch.from_numpy(_keys("random", 4 * TILE))
    cm.merge_level(cm.tile_sort(x), 0)
    rtt.sort(torch.arange(TILE + 5, dtype=torch.int32).flip(0),
             engine="merge")
    assert cm.launch_counts() == {"tile_sort": 0, "merge_level": 0}


def test_merge_wrappers_reject_bad_input():
    with pytest.raises(ValueError):  # not a whole number of tiles
        cm.tile_sort(torch.zeros(TILE + 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        cm.tile_sort(torch.zeros(TILE, dtype=torch.int64))
    with pytest.raises(ValueError):  # 2 tiles cannot pair runs of 2 tiles
        cm.merge_level(torch.zeros(2 * TILE, dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        cm.merge_sort_bits(torch.zeros(4, dtype=torch.int64))


# ------------------------------------------------------------- on the card

KINDS = ["random", "ties", "equal", "sorted", "reversed", "disjoint"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("tiles", [1, 3, 64, 133])
def test_cuda_tile_sort_matches_plain(cuda_device, kind, tiles):
    x = torch.from_numpy(_keys(kind, tiles * TILE, tiles)).to(cuda_device)
    before = cm.tile_sort.launches
    got = cm.tile_sort(x)
    assert cm.tile_sort.launches == before + 1
    torch.testing.assert_close(got, cm.tile_sort_plain(x), rtol=0, atol=0)


def _check_cuda_level(x, level):
    before = cm.merge_level.launches
    got, splits = cm.merge_level(x, level, with_splits=True)
    assert cm.merge_level.launches == before + 1
    want_splits = cm.level_splits_plain(x, level)
    for a, b in zip(splits, want_splits):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(got, cm.merge_level_plain(x, *want_splits),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [0, 2, 5])
def test_cuda_merge_level_matches_plain(cuda_device, kind, level):
    x = torch.from_numpy(_runs_sorted(_keys(kind, 64 * TILE, level),
                                      TILE << level)).to(cuda_device)
    _check_cuda_level(x, level)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "disjoint"])
@pytest.mark.parametrize("tiles, level", [(2, 0), (6, 0), (266, 0),
                                          (1024, 0), (1024, 4), (1024, 9)])
def test_cuda_merge_level_tile_counts(cuda_device, kind, tiles, level):
    """Pair counts that are no multiple of the persistent grid (266 tiles),
    and 1024 tiles, more than the CTAs that fit on the card at once."""
    x = torch.from_numpy(_runs_sorted(_keys(kind, tiles * TILE, tiles),
                                      TILE << level)).to(cuda_device)
    _check_cuda_level(x, level)


@pytest.mark.cuda
def test_cuda_merge_level_misaligned_view(cuda_device):
    """A view 4 bytes past a 16-byte boundary is merged right or refused
    with ValueError; it never reads outside the view."""
    n = 4 * TILE
    x = _runs_sorted(_keys("random", n, 9), TILE)
    buf = torch.full((n + 8,), -1, dtype=torch.int32, device=cuda_device)
    buf[1:1 + n] = torch.from_numpy(x).to(cuda_device)
    view = buf[1:1 + n]
    try:
        got, _ = cm.merge_level(view, 0)
    except ValueError:
        return
    want = cm.merge_level_plain(view, *cm.level_splits_plain(view, 0))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_merge_sort_launches(cuda_device):
    """A merge sort of 2^k tiles: one tile_sort and one merge_level launch a
    level, nothing else counted."""
    keys = torch.from_numpy(_keys("random", 16 * TILE)).to(cuda_device)
    cm.reset_launch_counts()
    rtt.sort(keys.view(torch.int32), engine="merge")
    assert cm.launch_counts() == {"tile_sort": 1, "merge_level": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 5000, TILE, 3 * TILE + 1, (1 << 22) - 777])
def test_cuda_merge_sort_matches_torch_sort(cuda_device, n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    keys[: n // 4] = 0xFFFFFFFF
    t = tdt.tensor_from_numpy(keys, cuda_device)
    got = tdt.tensor_to_numpy(rtt.sort(t, engine="merge"))
    np.testing.assert_array_equal(got, np.sort(keys))
