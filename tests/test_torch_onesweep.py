"""The onesweep radix pass: pass_histograms and onesweep_pass.

On this CPU the wrappers run their plain torch versions (the tensors lie on
the CPU) and the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them: the histogram of every pass is held
against the JAX ``digit_histogram`` summed over tiles, the look-back pass's
destinations against the JAX ``rank_pass`` with a JAX-stitched base, and the
sort's control flow (one host read a sort, filled passes skipped) against
the JAX sort.  The tests marked ``cuda`` hold both kernels, in both modes of
the pass kernel, against their plain versions on the card."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.ops import pallas_radix as pr
from radix_sort_tpu_torch import _build, convert, dtypes as tdt
from radix_sort_tpu_torch.config import KERNEL_SHAPES
from radix_sort_tpu_torch.ops import cuda_radix as cr, stream

TILE = 2048  # 16 rows x 128 lanes on the TPU side; one CTA tile here


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _jax_tile_sums(words: np.ndarray, radix: int, passes: int):
    """Per-pass digit totals of a uint32 plane by the JAX kernel: its
    per-tile counts of the digit (x >> shift) & (R - 1), summed over
    tiles."""
    bits = radix.bit_length() - 1
    hist = jax.jit(lambda x, s: pr.digit_histogram(
        ((x >> s) & (radix - 1)).astype(jnp.int32), radix, TILE).sum(0))
    x = jnp.asarray(words)
    return [np.asarray(hist(x, jnp.uint32(j * bits))) for j in range(passes)]


@pytest.mark.parametrize("radix", [2, 16, 256])
def test_pass_histograms_plain_matches_pallas(radix):
    """Every pass of a 64-bit key (lo plane, then hi plane) for radix 16
    and 256; every pass of one plane for radix 2."""
    rng = np.random.default_rng(radix)
    keys = rng.integers(0, 2**64, 3 * TILE, dtype=np.uint64)
    keys[::5] &= np.uint64(0xFFFF00FF00FF0F0F)  # uneven digits
    words = keys.view(np.uint32).reshape(-1, 2)
    bits = radix.bit_length() - 1
    nplanes = 1 if radix == 2 else 2
    passes = (32 // bits,) * nplanes
    planes = tuple(torch.from_numpy(words[:, w].copy().view(np.int32))
                   for w in range(nplanes))
    got = cr.pass_histograms(planes, passes, radix)
    assert got.dtype == torch.int32 and tuple(got.shape) == (sum(passes),
                                                            radix)
    want = [row for w in range(nplanes)
            for row in _jax_tile_sums(words[:, w].copy(), radix, passes[w])]
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_pass_histograms_short_passes_and_bad_input():
    """16-bit keys count two passes; the wrapper checks its arguments."""
    x = torch.tensor([0x1234, 0x1200, 0xFF34], dtype=torch.int32)
    got = cr.pass_histograms((x,), (2,), 256)
    assert got[0, 0x34] == 2 and got[0, 0x00] == 1
    assert got[1, 0x12] == 2 and got[1, 0xFF] == 1
    with pytest.raises(ValueError):
        cr.pass_histograms((x, x, x), (1, 1, 1), 256)
    with pytest.raises(ValueError):
        cr.pass_histograms((x,), (5,), 256)  # a fifth 8-bit digit
    with pytest.raises(ValueError):
        cr.pass_histograms((x,), (1,), 12)
    with pytest.raises(ValueError):
        cr.pass_histograms((x, x[:2]), (1, 1), 16)


@pytest.mark.parametrize("radix,shift", [(16, 4), (256, 8), (256, 24)])
@pytest.mark.parametrize("n", [3 * TILE, 3 * TILE + 500])
def test_onesweep_pass_plain_matches_rank_pass(radix, shift, n):
    """The look-back pass's plain destinations equal the JAX rank_pass with
    a JAX-stitched base, and its planes move as that pass moves them."""
    rng = np.random.default_rng(n + shift)
    keys = rng.integers(-2**31, 2**31, n).astype(np.int32)
    digits = ((keys.view(np.uint32) >> shift) & (radix - 1)).astype(np.int32)
    t = torch.from_numpy(keys)
    planes = (t, torch.arange(n, dtype=torch.int32))
    counts = torch.from_numpy(np.bincount(digits, minlength=radix)
                              .astype(np.int32))
    outs, dest = cr.onesweep_pass(t, planes, counts, radix, TILE, shift,
                                  with_dest=True)
    pad = -n % TILE  # the JAX kernel takes whole tiles: pad with digit R-1
    jd = jnp.asarray(np.concatenate([digits, np.full(pad, radix - 1,
                                                     np.int32)]))
    jbase = pr._stitch_block_base(pr.digit_histogram(jd, radix, TILE))
    want = np.asarray(pr.rank_pass(jd, jbase, radix, TILE))[:n]
    np.testing.assert_array_equal(dest.numpy(), want)
    order = np.argsort(digits, kind="stable")
    for p, o in zip(planes, outs):
        np.testing.assert_array_equal(o.numpy(), p.numpy()[order])


def test_onesweep_pass_writes_into_outs_and_checks_input():
    x = torch.arange(5000, dtype=torch.int32).flip(0)
    counts = cr.pass_histograms((x,), (1,), 16)[0]
    outs = (torch.empty_like(x), torch.empty_like(x))
    got, dest = cr.onesweep_pass(x, (x, x * 2), counts, 16, TILE, outs=outs)
    assert got[0] is outs[0] and got[1] is outs[1] and dest is None
    order = np.argsort(x.numpy() & 15, kind="stable")
    np.testing.assert_array_equal(outs[1].numpy(), (x * 2).numpy()[order])
    with pytest.raises(ValueError):
        cr.onesweep_pass(x, (x,), counts[:8], 16, TILE)
    with pytest.raises(ValueError):
        cr.onesweep_pass(x, (x,), counts, 16, TILE, outs=(x[:10],))
    with pytest.raises(ValueError):
        cr.onesweep_pass(x, (x[:10],), counts, 16, TILE)


def _expected_passes(bits_np: np.ndarray, key_bits: int) -> int:
    """Passes of 8 bits that no single digit fills."""
    words = bits_np.view(np.uint32)
    if bits_np.dtype.itemsize == 8:
        words = words.reshape(-1, 2)
    else:
        words = words.reshape(-1, 1)
    run = 0
    for s in range(0, key_bits, 8):
        d = (words[:, s // 32] >> np.uint32(s % 32)) & np.uint32(255)
        run += int(np.bincount(d, minlength=256).max() < d.size)
    return run


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


CASES = {
    "u32": (np.uint32, "RandomDistributed", 0),
    "i64_payloads": (np.int64, "Random", 2),
    "u16": (np.uint16, "RandomDistributed", 1),
    "zeros": (np.uint32, "Zeros", 1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sort_reads_host_once_and_skips_filled_passes(case, monkeypatch):
    """sort_kv on the CPU: one pass_histograms, one host read, one
    onesweep_pass for each pass that one digit does not fill; keys and
    payloads equal the JAX sort's."""
    dtype, dist, npay = CASES[case]
    n = 3001
    rng = np.random.default_rng(7)
    if dtype == np.uint16:
        keys = rng.integers(0, 2**16, n).astype(np.uint16)
        keys[::3] = 7
    else:
        ds = {d.name: d for d in rtt.datasets.make_datasets(dtype, 3)}[dist]
        keys = ds.generate(n)
    vals = [np.arange(n, dtype=np.int32),
            rng.standard_normal(n)][:max(npay, 1)]
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    reads = stream.host_reads
    tk = tdt.tensor_from_numpy(keys, "cpu")
    ok, ov = rtt.sort_kv(tk, tuple(torch.from_numpy(v) for v in vals))
    assert stream.host_reads == reads + 1
    bits = tdt.to_sortable(tk).numpy()
    assert spy.calls == _expected_passes(bits, tdt.key_bits(tk.dtype))
    jk, jv = rst.sort_kv(jnp.asarray(keys),
                         tuple(jnp.asarray(v) for v in vals))
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ok), np.asarray(jk))
    for a, b in zip(ov, jv):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("num_buckets", [2, 100, 256, 1000])
def test_partition_reads_host_once(num_buckets, monkeypatch):
    """partition_planes: one host read; its totals come from the pass
    histogram (up to 256 buckets) and the planes are stably partitioned."""
    rng = np.random.default_rng(num_buckets)
    n = 5000
    ids = rng.integers(0, num_buckets, n).astype(np.int32)
    pay = torch.arange(n, dtype=torch.int32)
    reads = stream.host_reads
    outs, counts = stream.partition_planes(torch.from_numpy(ids), (pay,),
                                           num_buckets)
    assert stream.host_reads == reads + 1
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=num_buckets))
    np.testing.assert_array_equal(outs[0].numpy(),
                                  np.argsort(ids, kind="stable"))
    one = torch.full((n,), num_buckets - 1, dtype=torch.int32)
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    outs, counts = stream.partition_planes(one, (pay,), num_buckets)
    assert outs[0] is pay and int(counts[-1]) == n
    assert spy.calls == 0


@pytest.mark.parametrize(
    "fn", [tdt.tensor_from_numpy, convert.table_from_numpy,
           rtt.Table.from_numpy],
    ids=["tensor_from_numpy", "table_from_numpy", "Table.from_numpy"])
def test_entry_points_default_to_the_card(fn):
    """Data enters the query path on the card unless the caller asks for
    the CPU."""
    assert inspect.signature(fn).parameters["device"].default == "cuda"


# ------------------------------------------------------------- on the card

def _keys(n, dist, device, tile=4096, radix=256, seed=0):
    rng = np.random.default_rng(seed)
    if dist == "random":
        k = rng.integers(-2**31, 2**31, n).astype(np.int32)
    elif dist == "zeros":
        k = np.zeros(n, np.int32)
    elif dist == "range":
        k = np.arange(n, dtype=np.int32)
    else:  # every tile one digit, the digits differing between tiles
        k = ((np.arange(n) // tile) * 7 % radix).astype(np.int32)
    return torch.from_numpy(k).to(device)


def _both_modes(k, planes, radix, tile, shift, threads):
    """The pass kernel in look-back and in base-table mode, and the plain
    version, with destinations."""
    counts = torch.bincount(cr._digits(k, radix, shift).long(),
                            minlength=radix).int()
    lb = cr.onesweep_pass(k, planes, counts, radix, tile, shift,
                          with_dest=True, threads=threads)
    base = cr._stitch_block_base(cr.digit_histogram(k, radix, tile, shift,
                                                    threads))
    bt = cr.rank_scatter(k, planes, base, radix, tile, shift,
                         with_dest=True, threads=threads)
    plain = cr.onesweep_pass_plain(k, planes, radix, tile, shift, True)
    return lb, bt, plain


def _assert_same(a, b):
    outs_a, dest_a = a
    outs_b, dest_b = b
    for x, y in zip(outs_a + (dest_a,), outs_b + (dest_b,)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,threads", KERNEL_SHAPES)
@pytest.mark.parametrize("n", [1, 4095, 4097, (1 << 20) + 77, 1 << 24])
def test_cuda_pass_kernel_both_modes_match_plain(cuda_device, n, tile,
                                                 threads):
    k = _keys(n, "random", cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    lb, bt, plain = _both_modes(k, (k, iota), 256, tile, 8, threads)
    _assert_same(lb, plain)
    _assert_same(bt, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["random", "zeros", "range", "tile_digit"])
@pytest.mark.parametrize("radix", [2, 16, 256])
def test_cuda_pass_kernel_radix_and_distributions(cuda_device, radix, dist):
    n = (1 << 20) + 77
    k = _keys(n, dist, cuda_device, radix=radix)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    lb, bt, plain = _both_modes(k, (k, iota, iota * 3), radix, 4096, 0, 256)
    _assert_same(lb, plain)
    _assert_same(bt, plain)


@pytest.mark.cuda
def test_cuda_pass_kernel_17_planes(cuda_device):
    """More planes than one launch takes: the look-back launch writes its
    tile bases and the 17th plane moves in base-table mode from them."""
    n = (1 << 20) + 77
    k = _keys(n, "random", cuda_device)
    planes = tuple(k + i for i in range(_build.lib().rst_max_planes() + 1))
    before = dict(cr.launch_counts())
    lb, bt, plain = _both_modes(k, planes, 256, 4096, 0, 256)
    after = cr.launch_counts()
    assert after["onesweep_pass"] == before["onesweep_pass"] + 1
    assert after["rank_scatter"] == before["rank_scatter"] + 3
    _assert_same(lb, plain)
    _assert_same(bt, plain)


@pytest.mark.cuda
def test_cuda_pass_kernel_digit_plane_not_moved(cuda_device):
    """The partition's pass: bucket ids give the digit and stay put."""
    n = (1 << 20) + 77
    ids = _keys(n, "random", cuda_device) & 255
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    lb, bt, plain = _both_modes(ids, (iota, iota * 5), 256, 4096, 0, 256)
    _assert_same(lb, plain)
    _assert_same(bt, plain)
    outs, counts = stream.partition_planes(ids, (iota,), 256)
    torch.testing.assert_close(outs[0], plain[0][0], rtol=0, atol=0)
    torch.testing.assert_close(
        counts, torch.bincount(ids.long(), minlength=256).int(), rtol=0,
        atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("radix", [2, 16, 256])
@pytest.mark.parametrize("n", [1, 4097, (1 << 20) + 77, 1 << 24])
def test_cuda_pass_histograms_matches_plain(cuda_device, n, radix):
    """Two planes (a 64-bit key), one launch; and a view off a 16-byte
    boundary."""
    bits = radix.bit_length() - 1
    lo = _keys(n + 1, "random", cuda_device, seed=1)
    hi = _keys(n, "range", cuda_device)
    planes, passes = (lo[1:], hi), (32 // bits, 32 // bits)
    before = cr.pass_histograms.launches
    got = cr.pass_histograms(planes, passes, radix)
    assert cr.pass_histograms.launches == before + 1
    torch.testing.assert_close(
        got, cr.pass_histograms_plain(planes, passes, radix), rtol=0, atol=0)
    zeros = torch.zeros(n, dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(
        cr.pass_histograms((zeros,), (3,), radix),
        cr.pass_histograms_plain((zeros,), (3,), radix), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.uint32, np.uint16])
def test_cuda_sort_matches_cpu_sort(cuda_device, dtype):
    """The whole onesweep sort on the card equals the same sort on the CPU
    (the plain versions), 64-bit keys included; one pass_histograms launch
    and one host read."""
    n = (1 << 22) + 5
    ds = rtt.datasets.RandomDistributed(dtype, seed=4)
    keys = ds.generate(n)
    iota = np.arange(n, dtype=np.int32)
    cr.reset_launch_counts()
    reads = stream.host_reads
    gk, gv = rtt.sort_kv(tdt.tensor_from_numpy(keys, cuda_device),
                         torch.from_numpy(iota).to(cuda_device))
    torch.cuda.synchronize()
    assert stream.host_reads == reads + 1
    counts = cr.launch_counts()
    assert counts["pass_histograms"] == 1
    assert counts["digit_histogram"] == 0 and counts["exclusive_scan"] == 0
    ck_in = tdt.tensor_from_numpy(keys, "cpu")
    assert counts["onesweep_pass"] == _expected_passes(
        tdt.to_sortable(ck_in).numpy(), tdt.key_bits(ck_in.dtype))
    ck, cv = rtt.sort_kv(ck_in, torch.from_numpy(iota))
    np.testing.assert_array_equal(tdt.tensor_to_numpy(gk),
                                  tdt.tensor_to_numpy(ck))
    np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())


@pytest.mark.cuda
def test_cuda_pass_kernel_repeated_calls_and_two_streams(cuda_device):
    """The same pass three times, then two passes enqueued on two streams
    before one synchronise: each call has its own zeroed scratch."""
    n = (1 << 22) + 5
    a = _keys(n, "random", cuda_device, seed=2)
    b = _keys(n + 3, "random", cuda_device, seed=3)
    ca = cr.pass_histograms((a,), (4,), 256)
    cb = cr.pass_histograms((b,), (4,), 256)
    want_a = cr.onesweep_pass_plain(a, (a,), 256, 4096, 16)
    want_b = cr.onesweep_pass_plain(b, (b,), 256, 4096, 16)
    for _ in range(3):
        _assert_same(cr.onesweep_pass(a, (a,), ca[2], 256, 4096, 16), want_a)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(s1):
        ra = cr.onesweep_pass(a, (a,), ca[2], 256, 4096, 16)
    with torch.cuda.stream(s2):
        rb = cr.onesweep_pass(b, (b,), cb[2], 256, 4096, 16)
    torch.cuda.synchronize()
    _assert_same(ra, want_a)
    _assert_same(rb, want_b)


@pytest.mark.cuda
def test_cuda_pass_kernel_64bit_status_words(cuda_device):
    """n >= 2^30 takes the 64-bit status words: digits come out in order,
    stably, with the histogram's counts (checked on the card; the plain
    version would need tens of GB at this size)."""
    n = (1 << 30) + 4099
    k = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      device=cuda_device)
    counts = cr.pass_histograms((k,), (4,), 256)
    (ok,), _ = cr.onesweep_pass(k, (k,), counts[1], 256, 4096, 8)
    d = cr._digits(ok, 256, 8)
    assert bool((d[1:] >= d[:-1]).all())
    torch.testing.assert_close(torch.bincount(d.long(), minlength=256).int(),
                               counts[1], rtol=0, atol=0)
    del ok, d
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    (ok, oi), _ = cr.onesweep_pass(k, (k, iota), counts[1], 256, 4096, 8)
    same = cr._digits(ok[1:], 256, 8) == cr._digits(ok[:-1], 256, 8)
    assert bool((~same | (oi[1:] > oi[:-1])).all())
    assert bool((k[oi.long()] == ok).all())
