"""The port's radix kernels against the JAX package's Pallas kernels.

On this CPU the wrappers run their plain torch versions (the tensors lie on
the CPU) and the JAX kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them.  The tests marked ``cuda`` hold each
CUDA kernel against its plain version on the card and skip without one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radix_sort_tpu.ops import pallas_radix as pr
from radix_sort_tpu_torch import _build
from radix_sort_tpu_torch.ops import cuda_radix as cr
from radix_sort_tpu_torch.status import EngineError

TILE = 2048  # 16 rows x 128 lanes on the TPU side; one CTA tile here
SCAN_TILE = 8192  # one CTA's tile of the CUDA scan (csrc/radix.cu kScanTile)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.parametrize("radix", [2, 16, 256])
def test_digit_histogram_matches_pallas(radix):
    rng = np.random.default_rng(radix)
    digits = rng.integers(0, radix, size=5 * TILE).astype(np.int32)
    want = np.asarray(pr.digit_histogram(jnp.asarray(digits), radix, TILE))
    got = cr.digit_histogram(torch.from_numpy(digits), radix, TILE)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_digit_histogram_extracts_digit_and_masks_ragged_tile():
    """The port's kernel reads a key plane and a shift (no digit pass);
    the ragged last tile counts only its real elements."""
    rng = np.random.default_rng(1)
    x = rng.integers(-2**31, 2**31, 3 * TILE + 77).astype(np.int32)
    got = cr.digit_histogram(torch.from_numpy(x), 16, TILE, shift=28).numpy()
    d = (x.view(np.uint32) >> 28) & 15
    for b in range(4):
        np.testing.assert_array_equal(
            got[b], np.bincount(d[b * TILE:(b + 1) * TILE], minlength=16))
    assert got.sum() == x.size


@pytest.mark.parametrize("n", [1, 100, 5000, 8192])
def test_exclusive_scan_matches_pallas(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 100, size=n).astype(np.int32)
    want = np.asarray(pr.exclusive_scan(jnp.asarray(x)))
    got = cr.exclusive_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [SCAN_TILE // 2 - 1, SCAN_TILE // 2,
                               SCAN_TILE // 2 + 1, SCAN_TILE - 1, SCAN_TILE,
                               SCAN_TILE + 1, (1 << 16) + 3])
def test_exclusive_scan_wrapping_matches_pallas(n):
    """Full-range values, so the prefix wraps int32 many times, at sizes
    around the CUDA kernel's tiles."""
    rng = np.random.default_rng(n)
    x = rng.integers(-2**31, 2**31, size=n).astype(np.int32)
    want = np.asarray(pr.exclusive_scan(jnp.asarray(x)))
    got = cr.exclusive_scan(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_exclusive_scan_wraps_like_int32():
    x = torch.tensor([2**31 - 1, 1, 5], dtype=torch.int32)
    np.testing.assert_array_equal(cr.exclusive_scan(x).numpy(),
                                  [0, 2**31 - 1, -2**31])


def test_stitch_block_base_matches_pallas():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 50, (6, 16)).astype(np.int32)
    want = np.asarray(pr._stitch_block_base(jnp.asarray(counts)))
    got = cr._stitch_block_base(torch.from_numpy(counts))
    np.testing.assert_array_equal(got.numpy(), want)
    small = torch.tensor([[2, 1], [3, 4]], dtype=torch.int32)
    np.testing.assert_array_equal(cr._stitch_block_base(small).numpy(),
                                  [[0, 5], [2, 6]])


@pytest.mark.parametrize("radix", [16, 256])
def test_rank_pass_matches_pallas(radix):
    rng = np.random.default_rng(radix + 2)
    digits = rng.integers(0, radix, size=3 * TILE).astype(np.int32)
    jd = jnp.asarray(digits)
    jbase = pr._stitch_block_base(pr.digit_histogram(jd, radix, TILE))
    want = np.asarray(pr.rank_pass(jd, jbase, radix, TILE))
    td = torch.from_numpy(digits)
    base = cr._stitch_block_base(cr.digit_histogram(td, radix, TILE))
    np.testing.assert_array_equal(base.numpy(), np.asarray(jbase))
    got = cr.rank_pass(td, base, radix, TILE)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [3 * TILE, 3 * TILE + 500])
def test_rank_scatter_moves_planes_stably(n):
    """rank_scatter = rank_pass + the scatter of every plane: the key plane
    and two payload planes land where the JAX rank_pass + scatter puts them
    (a stable counting sort by the digit)."""
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**31, 2**31, n).astype(np.int32)
    shift, radix = 8, 256
    t = torch.from_numpy(keys)
    planes = (t, torch.arange(n, dtype=torch.int32),
              torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              .view(torch.int32))
    base = cr._stitch_block_base(cr.digit_histogram(t, radix, TILE, shift))
    outs, dest = cr.rank_scatter(t, planes, base, radix, TILE, shift,
                                 with_dest=True)
    digits = (keys.view(np.uint32) >> shift) & (radix - 1)
    order = np.argsort(digits, kind="stable")
    for p, o in zip(planes, outs):
        np.testing.assert_array_equal(o.numpy(), p.numpy()[order])
    exp_dest = np.empty(n, np.int64)
    exp_dest[order] = np.arange(n)
    np.testing.assert_array_equal(dest.numpy(), exp_dest)
    if n % TILE == 0:  # the JAX kernel takes whole tiles only
        jd = jnp.asarray(digits.astype(np.int32))
        jbase = pr._stitch_block_base(pr.digit_histogram(jd, radix, TILE))
        np.testing.assert_array_equal(
            dest.numpy(), np.asarray(pr.rank_pass(jd, jbase, radix, TILE)))


def test_cpu_tensors_take_the_plain_path_without_launching():
    cr.reset_launch_counts()
    x = torch.arange(5000, dtype=torch.int32)
    base = cr._stitch_block_base(cr.digit_histogram(x, 16, TILE))
    cr.rank_scatter(x, (x,), base, 16, TILE)
    hist = cr.pass_histograms((x,), (2,), 16)
    cr.onesweep_pass(x, (x,), hist[0], 16, TILE)
    assert cr.launch_counts() == {"digit_histogram": 0, "exclusive_scan": 0,
                                  "rank_scatter": 0, "pass_histograms": 0,
                                  "onesweep_pass": 0, "wide_planes": 0,
                                  "wide_launches": 0}


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        cr.digit_histogram(torch.zeros(8, dtype=torch.int64), 16, TILE)
    with pytest.raises(ValueError):
        cr.digit_histogram(torch.zeros(8, dtype=torch.int32), 12, TILE)
    with pytest.raises(ValueError):
        cr.exclusive_scan(torch.zeros((2, 4), dtype=torch.int32))
    x = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError):
        cr.rank_scatter(x, (x,), torch.zeros((2, 16), dtype=torch.int32), 16,
                        TILE)
    with pytest.raises(EngineError):  # no silent path for other devices
        cr.exclusive_scan(torch.zeros(8, dtype=torch.int32, device="meta"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler failure raises EngineError; nothing falls back to the
    plain version."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'radix.cu: error' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "library_path",
                        lambda: tmp_path / "kernels" / "lib.so")
    with pytest.raises(EngineError, match="radix.cu: error"):
        _build.build()
    with pytest.raises(EngineError):
        _build.check(1, "launch")


# ------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize("radix,shift", [(2, 0), (16, 4), (256, 24)])
def test_cuda_digit_histogram_matches_plain(cuda_device, radix, shift):
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-2**31, 2**31, (1 << 20) + 77)
                         .astype(np.int32)).to(cuda_device)
    before = cr.digit_histogram.launches
    got = cr.digit_histogram(x, radix, 4096, shift)
    assert cr.digit_histogram.launches == before + 1
    torch.testing.assert_close(
        got, cr.digit_histogram_plain(x, radix, 4096, shift), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, 1 << 23, 1000003])
def test_cuda_exclusive_scan_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32)).to(
        cuda_device)
    torch.testing.assert_close(cr.exclusive_scan(x),
                               cr.exclusive_scan_plain(x), rtol=0, atol=0)


def _scan_input(n, fill, device):
    if fill == "random":
        x = np.random.default_rng(n).integers(-2**31, 2**31, n)
        return torch.from_numpy(x.astype(np.int32)).to(device)
    v = 0 if fill == "zeros" else 2**31 - 1
    return torch.full((n,), v, dtype=torch.int32, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("fill", ["random", "zeros", "max"])
@pytest.mark.parametrize("n", [1, 31, SCAN_TILE - 1, SCAN_TILE,
                               SCAN_TILE + 1, 2 * SCAN_TILE + 5, 1000003,
                               1 << 21, 1 << 23, 1 << 27])
def test_cuda_exclusive_scan_bit_exact(cuda_device, n, fill):
    """One launch a call, bit-exact against the plain cumsum, wrapping."""
    x = _scan_input(n, fill, cuda_device)
    before = cr.exclusive_scan.launches
    got = cr.exclusive_scan(x)
    assert cr.exclusive_scan.launches == before + 1
    torch.testing.assert_close(got, cr.exclusive_scan_plain(x), rtol=0,
                               atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [5, SCAN_TILE + 7, 1000003])
def test_cuda_exclusive_scan_misaligned_view(cuda_device, offset, n):
    """A view that starts off a 16-byte boundary: an unaligned head in the
    first tile, whole tiles after it."""
    base = _scan_input(n + offset, "random", cuda_device)
    x = base[offset:]
    assert x.data_ptr() % 16 != 0
    torch.testing.assert_close(cr.exclusive_scan(x),
                               cr.exclusive_scan_plain(x), rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_exclusive_scan_scratch_is_reset(cuda_device):
    """The same tensor three times in a row: each call zeroes its scratch."""
    x = _scan_input(1 << 23, "random", cuda_device)
    want = cr.exclusive_scan_plain(x)
    outs = [cr.exclusive_scan(x) for _ in range(3)]
    for got in outs:
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_exclusive_scan_two_streams(cuda_device):
    """Two scans enqueued on two streams before one synchronise."""
    a = _scan_input(1 << 23, "random", cuda_device)
    b = _scan_input((1 << 23) + 5, "random", cuda_device)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        ra = cr.exclusive_scan(a)
    with torch.cuda.stream(s2):
        rb = cr.exclusive_scan(b)
    torch.cuda.synchronize()
    torch.testing.assert_close(ra, cr.exclusive_scan_plain(a), rtol=0, atol=0)
    torch.testing.assert_close(rb, cr.exclusive_scan_plain(b), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,threads", [(4096, 256), (2048, 256),
                                          (4096, 128), (2048, 128)])
@pytest.mark.parametrize("dist", ["random", "zeros"])
def test_cuda_rank_scatter_matches_plain(cuda_device, tile, threads, dist):
    n = (1 << 20) + 333
    rng = np.random.default_rng(5)
    keys = (rng.integers(-2**31, 2**31, n).astype(np.int32)
            if dist == "random" else np.zeros(n, np.int32))
    k = torch.from_numpy(keys).to(cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    planes = (k, iota, iota * 3)
    base = cr._stitch_block_base(cr.digit_histogram(k, 256, tile, 8, threads))
    outs, dest = cr.rank_scatter(k, planes, base, 256, tile, 8,
                                 with_dest=True, threads=threads)
    pouts, pdest = cr.rank_scatter_plain(k, planes, base, 256, tile, 8,
                                         with_dest=True)
    for a, b in zip(outs + (dest,), pouts + (pdest,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_rank_scatter_more_planes_than_one_launch(cuda_device):
    n = 50000
    k = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      device=cuda_device)
    planes = tuple(k + i for i in range(_build.lib().rst_max_planes() + 3))
    base = cr._stitch_block_base(cr.digit_histogram(k, 16, 4096, 0))
    outs, _ = cr.rank_scatter(k, planes, base, 16, 4096, 0)
    pouts, _ = cr.rank_scatter_plain(k, planes, base, 16, 4096, 0)
    for a, b in zip(outs, pouts):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
