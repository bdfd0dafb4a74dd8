"""The onesweep radix pass: pass_histograms and onesweep_pass.

On this CPU the wrappers run their plain torch versions (the tensors lie on
the CPU) and the JAX Pallas kernels run in interpret mode, as
tests/test_pallas_kernels.py runs them: the histogram of every pass is held
against the JAX ``digit_histogram`` summed over tiles, the look-back pass's
destinations against the JAX ``rank_pass`` with a JAX-stitched base, and the
sort's control flow (no host read, one launch a pass, the filled passes
skipped by the plan each launch derives) against the JAX sort.  The tests
marked ``cuda`` hold both kernels, in both modes of the pass kernel, and
the plan against their plain versions on the card."""

import functools
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


def _wide_column(n: int, seed: int) -> np.ndarray:
    """int64 bits of float64 values with NaNs of several payloads, -0.0,
    +0.0 and infinities planted: what an 8-byte plane must move bit for
    bit."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(n)
    plants = np.array([np.nan, -np.nan, -0.0, 0.0, np.inf, -np.inf])
    f[rng.choice(n, min(n, 6 * len(plants)), replace=False)] = np.resize(
        plants, min(n, 6 * len(plants)))
    bits = f.view(np.int64).copy()
    bits[::97] = rng.integers(0x7FF0000000000001, 0x7FFFFFFFFFFFFFFF,
                              bits[::97].size)  # NaNs of other payloads
    return bits


def _pass_planes(t: torch.Tensor, n: int, payload: str):
    """A pass's planes: the key plane and an iota, and with "mixed" two
    8-byte planes (random int64, float64 bits) among more int32 ones."""
    iota = torch.arange(n, dtype=torch.int32)
    if payload == "int32":
        return (t, iota)
    rng = np.random.default_rng(n)
    i64 = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, n))
    return (t, iota, i64, iota * 3, torch.from_numpy(_wide_column(n, n)))


@pytest.mark.parametrize("payload", ["int32", "mixed"])
@pytest.mark.parametrize("radix,shift", [(16, 4), (256, 8), (256, 24)])
@pytest.mark.parametrize("n", [3 * TILE, 3 * TILE + 500])
def test_onesweep_pass_plain_matches_rank_pass(radix, shift, n, payload):
    """The look-back pass's plain destinations equal the JAX rank_pass with
    a JAX-stitched base, and its planes move as that pass moves them: int32
    planes, and 8-byte ones among them (whole and ragged last tiles)."""
    rng = np.random.default_rng(n + shift)
    keys = rng.integers(-2**31, 2**31, n).astype(np.int32)
    digits = ((keys.view(np.uint32) >> shift) & (radix - 1)).astype(np.int32)
    t = torch.from_numpy(keys)
    planes = _pass_planes(t, n, payload)
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
        self.fn, self.calls, self.plans = fn, 0, []

    def __call__(self, *a, **k):
        self.calls += 1
        self.plans.append(k.get("plan"))
        return self.fn(*a, **k)


def _planned_runs(spy: _Spy, radix: int = 256, kind: str = "u") -> list:
    """The passes the plain plan runs, from the plan of the spied sort's
    launches (one a pass, each with the sort's table)."""
    plan = spy.plans[0]
    assert len(spy.plans) == plan.table.shape[0]
    assert [p.index for p in spy.plans] == list(range(len(spy.plans)))
    return cr.plan_runs(plan.table, plan.keys, plan.passes0, radix, kind)


def _plain_plan(tk: torch.Tensor) -> list:
    """The passes the plain plan runs for a radix-256 sort of the CPU keys
    ``tk``: its key planes' pass table, read by ``plan_runs``."""
    d = tdt.key_dtype(tk.dtype)
    if d.itemsize < 4:
        planes, kind, passes = (tdt.as_container(tk),), d.kind, (d.itemsize,)
    else:
        planes = stream.key_word_planes(tdt.to_sortable(tk))
        kind, passes = "u", (4,) * len(planes)
    table = cr.pass_histograms(planes, passes, 256, kind)
    return cr.plan_runs(table, planes, passes[0], 256, kind)


def _own_storage(outs, ins) -> None:
    """No output tensor shares storage with an input."""
    held = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    for t in outs:
        if t.numel():
            assert t.untyped_storage().data_ptr() not in held


CASES = {
    "u32": (np.uint32, "RandomDistributed", 0),
    "i64_payloads": (np.int64, "Random", 2),
    "u16": (np.uint16, "RandomDistributed", 1),
    "zeros": (np.uint32, "Zeros", 1),
    # 8-byte payload planes (int64, uint64, float64 with NaNs and -0.0)
    # beside int32 ones; a narrow key; every pass filled (the last launch
    # copies); 20 payload planes, past the 16 of one launch
    "u32_wide_payloads": (np.uint32, "RandomDistributed", 4),
    "u16_wide_payloads": (np.uint16, "RandomDistributed", 4),
    "zeros_wide_payloads": (np.uint32, "Zeros", 4),
    "u32_20_payloads": (np.uint32, "RandomDistributed", 20),
}


def _case_payloads(npay: int, n: int, rng) -> list:
    """An int32 iota, float64, then int64 and uint64 columns (the float64
    ones with NaNs and -0.0), in turn with int32 ones past four."""
    vals = [np.arange(n, dtype=np.int32), rng.standard_normal(n),
            rng.integers(-2**63, 2**63 - 1, n),
            rng.integers(0, 2**64 - 1, n, dtype=np.uint64)]
    if npay >= 4:
        vals[1] = _wide_column(n, 3).view(np.float64)
    for i in range(4, npay):
        vals.append(rng.integers(-2**31, 2**31, n).astype(np.int32)
                    if i % 2 else _wide_column(n, i))
    return vals[:max(npay, 1)]


@pytest.mark.parametrize("case", list(CASES))
def test_sort_reads_no_host_and_skips_filled_passes(case, monkeypatch):
    """sort_kv on the CPU: one pass_histograms, no host read, one
    onesweep_pass launch for every pass, of which the plan runs those that
    one digit does not fill; the result is new storage; keys and payloads
    equal the JAX sort's."""
    dtype, dist, npay = CASES[case]
    n = 3001
    rng = np.random.default_rng(7)
    if dtype == np.uint16:
        keys = rng.integers(0, 2**16, n).astype(np.uint16)
        keys[::3] = 7
    else:
        ds = {d.name: d for d in rtt.datasets.make_datasets(dtype, 3)}[dist]
        keys = ds.generate(n)
    vals = _case_payloads(npay, n, rng)
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    reads = stream.host_reads
    tk = tdt.tensor_from_numpy(keys, "cpu")
    tv = tuple(torch.from_numpy(v) for v in vals)
    ok, ov = rtt.sort_kv(tk, tv)
    assert stream.host_reads == reads
    bits = tdt.to_sortable(tk).numpy()
    key_bits = tdt.key_bits(tk.dtype)
    assert spy.calls == key_bits // 8  # one launch a pass
    kind = tdt.key_dtype(tk.dtype).kind if key_bits < 32 else "u"
    assert sum(_planned_runs(spy, kind=kind)) == _expected_passes(bits,
                                                                  key_bits)
    _own_storage((ok,) + tuple(ov), (tk,) + tv)
    jk, jv = rst.sort_kv(jnp.asarray(keys),
                         tuple(jnp.asarray(v) for v in vals))
    np.testing.assert_array_equal(tdt.tensor_to_numpy(ok), np.asarray(jk))
    for a, b in zip(ov, jv):
        np.testing.assert_array_equal(tdt.tensor_to_numpy(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


@pytest.mark.parametrize("payload", ["int32", "int64"])
@pytest.mark.parametrize("num_buckets", [2, 100, 256, 1000])
def test_partition_reads_no_host(num_buckets, payload, monkeypatch):
    """partition_planes: no host read, one launch a pass (one up to 256
    buckets, two 8-bit passes for 1000); its totals come from the pass
    histogram (up to 256 buckets) and the planes are stably partitioned,
    an int32 plane or an 8-byte one.  Ids all of one bucket fill every
    pass: the plan runs none and the last launch copies the payload into
    new storage."""
    rng = np.random.default_rng(num_buckets)
    n = 5000
    ids = rng.integers(0, num_buckets, n).astype(np.int32)
    base = 0 if payload == "int32" else 1 << 40  # both words vary
    pay = torch.arange(n, dtype=getattr(torch, payload)) + base
    launches = 1 if num_buckets <= 256 else 2
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    reads = stream.host_reads
    outs, counts = stream.partition_planes(torch.from_numpy(ids), (pay,),
                                           num_buckets)
    assert stream.host_reads == reads
    assert spy.calls == launches
    assert all(_planned_runs(spy))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ids, minlength=num_buckets))
    np.testing.assert_array_equal(outs[0].numpy() - base,
                                  np.argsort(ids, kind="stable"))
    one = torch.full((n,), num_buckets - 1, dtype=torch.int32)
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    outs, counts = stream.partition_planes(one, (pay,), num_buckets)
    assert stream.host_reads == reads
    assert spy.calls == launches and not any(_planned_runs(spy))
    assert int(counts[-1]) == n
    torch.testing.assert_close(outs[0], pay, rtol=0, atol=0)
    _own_storage(outs, (pay, one))


# Keys of a u32 (or u64) sort by the passes its plan runs: no pass, a filled
# first pass before running ones, a filled last pass after them, and a
# 64-bit key whose high word fills its four passes.
PLAN_CASES = {
    "none_runs": (np.uint32, [False] * 4),
    "filled_first": (np.uint32, [False, True, True, True]),
    "filled_last": (np.uint32, [True, True, True, False]),
    "u64_high_word_filled": (np.uint64, [True] * 4 + [False] * 4),
}


def _plan_keys(case: str, n: int) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "none_runs":
        return np.full(n, 0x5A5A5A5A, np.uint32)
    if case == "filled_first":
        return (rng.integers(0, 1 << 24, n).astype(np.uint32) << 8) | 0x5A
    if case == "filled_last":
        return rng.integers(0, 1 << 24, n).astype(np.uint32)
    return rng.integers(0, 1 << 32, n, dtype=np.uint64)


def _plan_launches(keys: np.ndarray, device):
    """A sort's planes (key words + an iota) in IN, zeroed OUT and TMP, its
    table and one PassPlan a pass, as ops/stream.py builds them."""
    n = keys.size
    words = keys.view(np.int32).reshape(n, -1)
    keys_in = tuple(torch.from_numpy(words[:, w].copy()).to(device)
                    for w in range(words.shape[1]))
    planes = keys_in + (torch.arange(n, dtype=torch.int32, device=device),)
    outs = tuple(torch.zeros_like(p) for p in planes)
    tmp = tuple(torch.zeros_like(p) for p in planes)
    passes = (4,) * len(keys_in)
    table = cr.pass_histograms(keys_in, passes, 256)
    rows = [(w, 8 * j) for w in range(len(keys_in)) for j in range(4)]
    return planes, outs, tmp, table, [
        (w, shift, cr.PassPlan(table, p, keys_in, 4, tmp))
        for p, (w, shift) in enumerate(rows)]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_plain_plan_runs_reads_and_writes_its_sets(case):
    """The plain plan on the CPU: which passes run, each launch's role, and
    the set each launch writes: the k-th of m running passes reads what the
    one before wrote and writes OUT when m - 1 - k is even, a filled pass
    writes nothing, and with m == 0 the last launch copies IN to OUT.  IN
    is never written; OUT ends as the stable sort, in its own storage."""
    dtype, want_runs = PLAN_CASES[case]
    n = 3 * TILE + 5
    keys = _plan_keys(case, n)
    planes, outs, tmp, table, launches = _plan_launches(keys, "cpu")
    saved = tuple(p.clone() for p in planes)
    runs = cr.plan_runs(table, launches[0][2].keys, 4, 256)
    assert runs == want_runs
    m = sum(runs)
    sets = (planes, outs, tmp)
    order = np.arange(n)  # the permutation after the passes so far
    u = keys.astype(np.uint64)
    for p, (w, shift, plan) in enumerate(launches):
        before = [tuple(b.clone() for b in st) for st in sets]
        got, dest = cr.onesweep_pass(planes[w], planes, table[p], 256, TILE,
                                     shift, outs=outs, plan=plan)
        assert got is outs and dest is None
        mode, src, dst = cr.pass_role(runs, p)
        k = sum(runs[:p])
        if runs[p]:
            assert mode == "run" and dst == (1 if (m - 1 - k) % 2 == 0 else 2)
            assert src == (0 if k == 0 else (1 if (m - k) % 2 == 0 else 2))
            digit = (u[order] >> np.uint64(32 * w + shift)) & np.uint64(255)
            order = order[np.argsort(digit, kind="stable")]
            np.testing.assert_array_equal(sets[dst][-1].numpy(), order)
        elif m == 0 and p == len(runs) - 1:
            assert (mode, src, dst) == ("copy", 0, 1)
            dst = 1
        else:
            assert mode == "skip"
            dst = None
        for i, st in enumerate(sets):  # only the set written changed
            if i != dst:
                for b, a in zip(before[i], st):
                    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(planes, saved):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_array_equal(outs[-1].numpy(),
                                  np.argsort(keys, kind="stable"))
    _own_storage(outs, planes)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_cuda_plan_matches_plain(cuda_device, case):
    """Each launch of a sort's passes on the card leaves IN, OUT and TMP
    as the plain plan leaves them, bit for bit, at a ragged n (a copy, a
    filled pass and running ones)."""
    n = (1 << 20) + 77
    keys = _plan_keys(case, n)
    card = _plan_launches(keys, cuda_device)
    plain = _plan_launches(keys, cuda_device)
    for (w, shift, plan), (_, _, pplan) in zip(card[4], plain[4]):
        cr.onesweep_pass(card[0][w], card[0], card[3][plan.index], 256,
                         8192, shift, outs=card[1], plan=plan)
        cr.onesweep_pass_plain(plain[0][w], plain[0], 256, 8192, shift,
                               plan=pplan, outs=plain[1])
        for a_set, b_set in zip(card[:3], plain[:3]):
            for a, b in zip(a_set, b_set):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


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
    """Planes and destinations equal bit for bit (a float16 key plane
    through its int16 view: NaN bits too)."""
    outs_a, dest_a = a
    outs_b, dest_b = b
    for x, y in zip(outs_a + (dest_a,), outs_b + (dest_b,)):
        if x is not None and x.dtype == torch.float16:
            x, y = x.view(torch.int16), y.view(torch.int16)
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
    (the plain versions), 64-bit keys included; one pass_histograms launch,
    one onesweep_pass launch a pass, and no host read."""
    n = (1 << 22) + 5
    ds = rtt.datasets.RandomDistributed(dtype, seed=4)
    keys = ds.generate(n)
    iota = np.arange(n, dtype=np.int32)
    cr.reset_launch_counts()
    reads = stream.host_reads
    gk_in = tdt.tensor_from_numpy(keys, cuda_device)
    gv_in = torch.from_numpy(iota).to(cuda_device)
    gk, gv = rtt.sort_kv(gk_in, gv_in)
    torch.cuda.synchronize()
    assert stream.host_reads == reads
    counts = cr.launch_counts()
    assert counts["pass_histograms"] == 1
    assert counts["digit_histogram"] == 0 and counts["exclusive_scan"] == 0
    ck_in = tdt.tensor_from_numpy(keys, "cpu")
    key_bits = tdt.key_bits(ck_in.dtype)
    assert counts["onesweep_pass"] == key_bits // 8  # one launch a pass
    assert sum(_plain_plan(ck_in)) == _expected_passes(
        tdt.to_sortable(ck_in).numpy(), key_bits)
    _own_storage((gk, gv), (gk_in, gv_in))
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


# ------------------------------------------------------- narrow key planes
#
# A 1- or 2-byte key reaches the kernels as the caller's own bits with its
# kind; the kernels take each digit from the key's sortable image and move
# the bits.  The widened path (dtypes.to_sortable → an int32 image plane →
# the same kernels) is what the narrow one must equal, bit for bit.

NARROW = {"u8": np.uint8, "i8": np.int8, "u16": np.uint16, "i16": np.int16,
          "f16": np.float16}


def _narrow_keys(dtype, n: int, seed: int, dist: str = "random"):
    """``datasets`` keys of ``dtype`` made from a seed, with the type's
    extremes (floats: NaNs of both signs, +-0, +-inf, subnormals) planted
    and a run of 300 equal keys.  float16 takes half its keys from random
    bit patterns, since RandomDistributed's [-1e9, 1e9) overflows it.
    ``dist`` "range": Range keys (sorted; a wide type's high digit repeats
    in long runs); "one_high_digit": every key's image shares its high
    byte, so a 16-bit sort's second pass is filled."""
    d = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    u = np.dtype(f"u{d.itemsize}")
    if dist == "range":
        return rtt.datasets.Range(d).generate(n)
    if dist == "one_high_digit":
        low = rng.integers(0, 256 if d.itemsize > 1 else 1, n)
        img = (np.uint64(0x5A) << np.uint64(8 * d.itemsize - 8)) | \
            low.astype(np.uint64)
        return tdt.np_from_sortable_unsigned(img.astype(u), d)
    with np.errstate(over="ignore"):
        keys = rtt.datasets.RandomDistributed(d, seed=seed).generate(n)
    if d.kind == "f":
        half = rng.random(n) < 0.5
        keys[half] = rng.integers(0, 1 << 16, int(half.sum()),
                                  dtype=np.uint16).view(d)
        sub = np.finfo(d).smallest_subnormal
        plants = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf,
                           sub, -sub, 3 * sub, -3 * sub], d)
        plants = np.concatenate([plants, np.array([0x7E01, 0xFE01, 0x7C01],
                                                  np.uint16).view(d)])
    else:
        ii = np.iinfo(d)
        plants = np.array([ii.min, ii.max, 0, 1, ii.min + 1, ii.max - 1], d)
    at = rng.choice(n, 8 * len(plants), replace=False)
    keys[at] = np.tile(plants, 8)
    start = int(rng.integers(0, n - 300))
    keys[start:start + 300] = keys[start]
    return keys


def _widened(keys_t: torch.Tensor) -> torch.Tensor:
    """The widened path's key plane: the image zero-extended into int32."""
    return tdt.to_sortable(keys_t)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> None:
    np.testing.assert_array_equal(tdt.tensor_to_numpy(a).view(np.uint8),
                                  tdt.tensor_to_numpy(b).view(np.uint8))


@pytest.mark.parametrize("radix", [16, 256])
@pytest.mark.parametrize("dist", ["random", "range", "one_high_digit"])
@pytest.mark.parametrize("dtype", list(NARROW))
def test_narrow_plain_pass_matches_widened(dtype, dist, radix):
    """pass_histograms and every onesweep_pass of a narrow key plane (the
    plain versions, which the wrappers run on the CPU) equal the widened
    path's bit for bit: the histogram rows, the moved key bits (through
    their image), the payload and the destinations; at a ragged n."""
    d = np.dtype(NARROW[dtype])
    n = 3 * TILE + 777
    keys = tdt.tensor_from_numpy(_narrow_keys(d, n, 31, dist), "cpu")
    plane = tdt.as_container(keys)
    wide = _widened(keys)
    iota = torch.arange(n, dtype=torch.int32)
    bits = radix.bit_length() - 1
    passes = -(-8 * d.itemsize // bits)
    hist = cr.pass_histograms((plane,), (passes,), radix, kind=d.kind)
    torch.testing.assert_close(hist, cr.pass_histograms((wide,), (passes,),
                                                        radix),
                               rtol=0, atol=0)
    for j in range(passes):
        (ko, vo), dest = cr.onesweep_pass(plane, (plane, iota), hist[j],
                                          radix, TILE, j * bits,
                                          with_dest=True, kind=d.kind)
        (wo, wv), wdest = cr.onesweep_pass(wide, (wide, iota), hist[j],
                                           radix, TILE, j * bits,
                                           with_dest=True)
        assert ko.dtype == plane.dtype
        torch.testing.assert_close(_widened(tdt.from_container(ko, d)), wo,
                                   rtol=0, atol=0)
        torch.testing.assert_close(vo, wv, rtol=0, atol=0)
        torch.testing.assert_close(dest, wdest, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", list(NARROW))
def test_narrow_sort_skips_filled_passes_and_keeps_the_callers_bits(
        dtype, monkeypatch):
    """A pass that one digit fills is launched and the plan skips it; a
    sort whose every pass is filled gives the caller's key bits and payload
    back in storage of their own (the last launch copies them), with no
    host read."""
    d = np.dtype(NARROW[dtype])
    n = 2 * TILE + 5
    keys = tdt.tensor_from_numpy(_narrow_keys(d, n, 5, "one_high_digit"),
                                 "cpu")
    plane = tdt.as_container(keys)
    iota = torch.arange(n, dtype=torch.int32)
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    reads = stream.host_reads
    ko, (vo,) = stream.sort_narrow_planes(plane, d.kind, (iota,))
    assert spy.calls == d.itemsize  # one launch a pass
    # the high byte fills its pass
    assert _planned_runs(spy, kind=d.kind) == [True] * (d.itemsize - 1) + [
        False]
    same = plane[3].repeat(n)
    spy = _Spy(cr.onesweep_pass)
    monkeypatch.setattr(cr, "onesweep_pass", spy)
    ko2, (vo2,) = stream.sort_narrow_planes(same, d.kind, (iota,))
    assert spy.calls == d.itemsize
    assert not any(_planned_runs(spy, kind=d.kind))
    assert stream.host_reads == reads
    _bits_equal(ko2, same)
    torch.testing.assert_close(vo2, iota, rtol=0, atol=0)
    _own_storage((ko2, vo2), (same, iota))
    ko2[0] += 1
    vo2[0] += 1
    assert int(same[0]) == int(plane[3]) and int(iota[0]) == 0
    img = tdt.np_to_sortable_unsigned(tdt.tensor_to_numpy(keys))
    perm = np.argsort(img, kind="stable")
    np.testing.assert_array_equal(vo.numpy(), perm)
    _bits_equal(tdt.from_container(ko, d), keys[torch.from_numpy(perm)])


NARROW_SORT_N = 2 * TILE + 333


@functools.cache
def _jax_narrow_sorts(dtype: str, engine: str):
    """The JAX package's sort, sort_kv and argsort of ``_narrow_keys``
    under its Pallas engine (interpret mode on the CPU) or its default."""
    from radix_sort_tpu.config import SortConfig as JaxSortConfig

    keys = jnp.asarray(_narrow_keys(NARROW[dtype], NARROW_SORT_N, 17))
    vals = jnp.arange(NARROW_SORT_N, dtype=jnp.int32) * 7
    kw = ({"config": JaxSortConfig(bits_per_pass=8, block_elems=TILE,
                                   engine="pallas")}
          if engine == "pallas" else {})
    jk, jv = rst.sort_kv(keys, vals, **kw)
    return (np.asarray(rst.sort(keys, **kw)), np.asarray(jk), np.asarray(jv),
            np.asarray(rst.argsort(keys, **kw)))


@pytest.mark.parametrize("jax_engine", ["pallas", "default"])
@pytest.mark.parametrize("engine", ["auto", "radix", "merge", "pallas"])
@pytest.mark.parametrize("dtype", list(NARROW))
def test_narrow_sorts_match_jax_bit_for_bit(dtype, engine, jax_engine):
    """sort, sort_kv and argsort of narrow keys, under every engine name
    that takes the narrow pass, equal the JAX package's bit for bit: its
    Pallas engine (interpret mode on the CPU) and its default engine."""
    keys = _narrow_keys(NARROW[dtype], NARROW_SORT_N, 17)
    vals = torch.arange(NARROW_SORT_N, dtype=torch.int32) * 7
    tk = tdt.tensor_from_numpy(keys, "cpu")
    js, jk, jv, ja = _jax_narrow_sorts(dtype, jax_engine)
    ko, vo = rtt.sort_kv(tk, vals, engine=engine)
    for got, want in ((rtt.sort(tk, engine=engine), js), (ko, jk)):
        np.testing.assert_array_equal(
            tdt.tensor_to_numpy(got).view(np.uint8), want.view(np.uint8))
    np.testing.assert_array_equal(vo.numpy(), jv)
    np.testing.assert_array_equal(rtt.argsort(tk, engine=engine).numpy(), ja)


def test_narrow_key_plane_checks():
    """The wrappers take int32 planes and narrow key planes of the five
    dtypes with a kind; a narrow plane only as the key plane itself, and
    alone in pass_histograms."""
    k8 = torch.arange(300, dtype=torch.uint8)
    k16 = torch.arange(300, dtype=torch.int16)
    x32 = torch.arange(300, dtype=torch.int32)
    counts = cr.pass_histograms((k8,), (1,), 256, kind="u")[0]
    with pytest.raises(ValueError):  # no such kind
        cr.onesweep_pass(k8, (k8,), counts, 256, TILE, kind="x")
    with pytest.raises(ValueError):  # an int32 word plane is read as bits
        cr.onesweep_pass(x32, (x32,), counts, 256, TILE, kind="i")
    with pytest.raises(ValueError):  # a narrow plane that is not the key's
        cr.onesweep_pass(k8, (k8.clone(),), counts, 256, TILE, kind="u")
    with pytest.raises(ValueError):  # a shift past the key's bits
        cr.onesweep_pass(k8, (k8,), counts, 256, TILE, 8, kind="u")
    with pytest.raises(ValueError):
        cr.pass_histograms((k16, x32), (2, 1), 256, kind="i")
    with pytest.raises(ValueError):  # a third 8-bit pass of a 16-bit key
        cr.pass_histograms((k16,), (3,), 256, kind="i")
    with pytest.raises(ValueError):
        cr.pass_histograms((torch.zeros(8, dtype=torch.bfloat16),), (2,),
                           256, kind="f")
    with pytest.raises(ValueError):
        cr.pass_histograms((torch.zeros(8, dtype=torch.int64),), (1,), 256)
    # the narrow plane moves at its width, the int32 payload as before
    kf = k8.flip(0).contiguous()
    (ko, xo), _ = cr.onesweep_pass(kf, (kf, x32), counts, 256, TILE,
                                   kind="u")
    assert ko.dtype == torch.uint8 and xo.dtype == torch.int32
    np.testing.assert_array_equal(xo.numpy(),
                                  np.argsort(kf.numpy(), kind="stable"))


# ---------------------------------------------- narrow planes on the card

def _narrow_on(device, dtype, n: int, dist: str, seed: int = 0):
    """Narrow keys on the card: ``_narrow_keys`` ("random", "range"), or
    long runs of equal keys: "few" (8 distinct values, shuffled), "runs"
    (runs of 5000 equal keys, their values sorted, then reversed)."""
    d = np.dtype(dtype)
    rng = np.random.default_rng(seed)
    if dist in ("random", "range"):
        keys = _narrow_keys(d, n, seed, dist)
    else:
        pool = _narrow_keys(d, 4096, seed)[rng.choice(4096, 8,
                                                      replace=False)]
        if dist == "few":
            keys = pool[rng.integers(0, 8, n)]
        else:
            order = np.argsort(tdt.np_to_sortable_unsigned(pool),
                               kind="stable")
            ramp = np.concatenate([order, order[::-1]])
            keys = pool[ramp[(np.arange(n) // 5000) % ramp.size]]
    return tdt.as_container(tdt.tensor_from_numpy(keys, device))


def _narrow_modes(k, kind, planes, radix, tile, shift, threads=256):
    """A narrow key plane's pass in look-back and base-table mode, and the
    plain version, with destinations."""
    counts = torch.bincount(cr._digits(k, radix, shift, kind).long(),
                            minlength=radix).int()
    lb = cr.onesweep_pass(k, planes, counts, radix, tile, shift,
                          with_dest=True, threads=threads, kind=kind)
    base = cr._stitch_block_base(cr.digit_histogram_plain(k, radix, tile,
                                                          shift, kind))
    bt = cr.rank_scatter(k, planes, base, radix, tile, shift, with_dest=True,
                         threads=threads, kind=kind)
    plain = cr.onesweep_pass_plain(k, planes, radix, tile, shift, True, kind)
    return lb, bt, plain


def _assert_stable(k, kind, radix, shift, planes_out, payload_pos):
    """The payload at payload_pos (an iota) came out as the stable
    permutation by digit."""
    perm = planes_out[payload_pos].long()
    d_in = cr._digits(k, radix, shift, kind)
    d_out = d_in[perm]
    assert bool((d_out[1:] >= d_out[:-1]).all())
    tie = d_out[1:] == d_out[:-1]
    assert bool((~tie | (perm[1:] > perm[:-1])).all())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [2048, 4096, 8192])
@pytest.mark.parametrize("radix", [16, 256])
@pytest.mark.parametrize("dtype", list(NARROW))
def test_cuda_narrow_pass_kernels_match_plain(cuda_device, dtype, radix,
                                              tile):
    """pass_histograms and every pass of a narrow KV sort, both modes, at a
    ragged n, against the plain versions bit for bit."""
    d = np.dtype(NARROW[dtype])
    n = (1 << 20) + 77
    k = _narrow_on(cuda_device, d, n, "random")
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    bits = radix.bit_length() - 1
    passes = -(-8 * d.itemsize // bits)
    before = cr.narrow_launch_counts()[f"pass_histograms_{8 * d.itemsize}bit"]
    hist = cr.pass_histograms((k,), (passes,), radix, kind=d.kind)
    assert cr.narrow_launch_counts()[
        f"pass_histograms_{8 * d.itemsize}bit"] == before + 1
    torch.testing.assert_close(
        hist, cr.pass_histograms_plain((k,), (passes,), radix, d.kind),
        rtol=0, atol=0)
    for j in range(passes):
        lb, bt, plain = _narrow_modes(k, d.kind, (k, iota, iota * 3), radix,
                                      tile, j * bits)
        _assert_same(lb, plain)
        _assert_same(bt, plain)
        assert lb[0][0].dtype == k.dtype
        _assert_stable(k, d.kind, radix, j * bits, lb[0], 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["few", "runs", "range", "off_boundary"])
@pytest.mark.parametrize("dtype", list(NARROW))
def test_cuda_narrow_pass_equal_runs(cuda_device, dtype, dist):
    """Long runs of equal keys (few distinct keys, sorted and reversed
    runs, Range), and a key plane that starts off a 4-byte boundary (the
    key-by-key loads): the payload comes out as the stable permutation,
    and both modes equal the plain version."""
    d = np.dtype(NARROW[dtype])
    n = (1 << 21) + 5
    if dist == "off_boundary":
        k = _narrow_on(cuda_device, d, n + 1, "few", seed=3)[1:]
    else:
        k = _narrow_on(cuda_device, d, n, dist, seed=2)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    for shift in range(0, 8 * d.itemsize, 8):
        lb, bt, plain = _narrow_modes(k, d.kind, (iota, k), 256, 8192, shift)
        _assert_same(lb, plain)
        _assert_same(bt, plain)
        _assert_stable(k, d.kind, 256, shift, lb[0], 0)
        _assert_same(((lb[0][1],), None), ((k[lb[0][0].long()],), None))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "f16"])
def test_cuda_narrow_pass_17_planes(cuda_device, dtype):
    """More planes than one launch takes: the narrow key plane goes in the
    look-back launch and the 17th plane in a base-table launch from its
    tile bases, reading the same narrow digit plane."""
    d = np.dtype(NARROW[dtype])
    n = (1 << 20) + 77
    k = _narrow_on(cuda_device, d, n, "random", seed=4)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    planes = (k,) + tuple(iota + i for i in range(_build.lib()
                                                  .rst_max_planes()))
    before = dict(cr.launch_counts())
    lb, bt, plain = _narrow_modes(k, d.kind, planes, 256, 8192, 0)
    after = cr.launch_counts()
    assert after["onesweep_pass"] == before["onesweep_pass"] + 1
    assert after["rank_scatter"] == before["rank_scatter"] + 3
    _assert_same(lb, plain)
    _assert_same(bt, plain)


@pytest.mark.cuda
def test_cuda_narrow_pass_64bit_status_words(cuda_device):
    """n >= 2^30 takes the 64-bit status words with a narrow key plane too:
    the key bits come out in image order, stably, with the histogram's
    counts (checked on the card)."""
    n = (1 << 30) + 4099
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    k = torch.randint(-2**15, 2**15, (n,), dtype=torch.int16,
                      device=cuda_device, generator=gen).view(torch.float16)
    counts = cr.pass_histograms((k,), (2,), 256, kind="f")
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    (ok, oi), _ = cr.onesweep_pass(k, (k, iota), counts[1], 256, 8192, 8,
                                   kind="f")
    d = cr._digits(ok, 256, 8, "f")
    assert bool((d[1:] >= d[:-1]).all())
    torch.testing.assert_close(torch.bincount(d.long(), minlength=256).int(),
                               counts[1], rtol=0, atol=0)
    same = d[1:] == d[:-1]
    assert bool((~same | (oi[1:] > oi[:-1])).all())
    assert bool((k.view(torch.int16)[oi.long()] == ok.view(torch.int16))
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(NARROW))
def test_cuda_narrow_sort_kv_matches_cpu_sort(cuda_device, dtype):
    """sort_kv of narrow keys on the card equals the same sort on the CPU
    (the plain versions): one pass_histograms and one onesweep_pass a byte
    of key, all with the narrow key plane, the passes the plain plan runs,
    and no host read."""
    d = np.dtype(NARROW[dtype])
    n = (1 << 22) + 5
    keys = _narrow_keys(d, n, 9)
    iota = np.arange(n, dtype=np.int32)
    cr.reset_launch_counts()
    reads = stream.host_reads
    gk_in = tdt.tensor_from_numpy(keys, cuda_device)
    gv_in = torch.from_numpy(iota).to(cuda_device)
    gk, gv = rtt.sort_kv(gk_in, gv_in)
    torch.cuda.synchronize()
    assert stream.host_reads == reads
    ck_in = tdt.tensor_from_numpy(keys, "cpu")
    assert sum(_plain_plan(ck_in)) == _expected_passes(
        tdt.to_sortable(ck_in).numpy(), 8 * d.itemsize)
    _own_storage((gk, gv), (gk_in, gv_in))
    bits = 8 * d.itemsize
    assert cr.launch_counts()["pass_histograms"] == 1
    narrow = cr.narrow_launch_counts()
    assert narrow[f"pass_histograms_{bits}bit"] == 1
    assert narrow[f"onesweep_pass_{bits}bit"] == d.itemsize
    assert cr.launch_counts()["onesweep_pass"] == d.itemsize
    ck, cv = rtt.sort_kv(tdt.tensor_from_numpy(keys, "cpu"),
                         torch.from_numpy(iota))
    _bits_equal(gk.cpu(), ck)
    np.testing.assert_array_equal(gv.cpu().numpy(), cv.numpy())


# ------------------------------------------------- 8-byte payload planes
#
# An int64, uint64 or float64 payload rides the passes as one 8-byte plane:
# the plane handed to the kernels is a view of the caller's column, and the
# column comes back as a view of the sorted plane.  The distributed layer's
# exchange still packs int32 word planes.

class _Calls:
    """Records each call's arguments and result."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *a, **k):
        out = self.fn(*a, **k)
        self.calls.append((a, k, out))
        return out


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("dtype", ["int64", "uint64", "float64"])
@pytest.mark.parametrize("entry", ["sort_kv", "stable_partition"])
def test_wide_payload_rides_without_a_copy(entry, dtype, monkeypatch):
    """sort_kv and stable_partition hand cuda_radix.sort_passes the 8-byte
    column itself (an int64 view of its storage, never split into word
    planes) and return a view of the sorted plane, bits intact."""
    n = 3 * TILE + 77
    bits = _wide_column(n, 11)
    col = torch.from_numpy(bits).view(getattr(torch, dtype))
    iota = torch.arange(n, dtype=torch.int32)
    sort_spy = _Calls(cr.sort_passes)
    split_spy = _Calls(stream.key_word_planes)
    monkeypatch.setattr(cr, "sort_passes", sort_spy)
    monkeypatch.setattr(stream, "key_word_planes", split_spy)
    rng = np.random.default_rng(5)
    if entry == "sort_kv":
        keys = rng.integers(0, 50, n).astype(np.int32)
        _, (got, perm) = rtt.sort_kv(torch.from_numpy(keys), (col, iota))
        order = rtt.golden.oracle_argsort(keys)
    else:
        ids = rng.integers(0, 7, n).astype(np.int32)
        (got, perm), _, _ = rtt.ops.partition.stable_partition(
            torch.from_numpy(ids), (col, iota), 7, method="stream")
        order = rtt.golden.oracle_argsort(ids)
    (args, kwargs, (outs, _)), = sort_spy.calls
    planes = args[2] if len(args) > 2 else kwargs["planes"]
    wide = [p for p in planes if p.element_size() == 8]
    assert len(wide) == 1 and wide[0].dtype == torch.int64
    assert _storage(wide[0]) == _storage(col)
    assert all(p.numel() == n for p in planes)
    # no word split of the payload: only a key's planes are split
    assert all(c[0][0].element_size() == 4 for c in split_spy.calls)
    assert _storage(got) in {_storage(o) for o in outs}
    np.testing.assert_array_equal(perm.numpy(), order)
    np.testing.assert_array_equal(
        tdt.tensor_to_numpy(got).view(np.int64), bits[order])


def test_exchange_still_packs_int32_word_planes(monkeypatch):
    """parallel/'s exchange moves an 8-byte column as one int64 plane, the
    plane the radix pass moves, and packs it into the collectives' int32
    block as its two words a row: packed_all_to_all and ragged_all_to_all
    (their partition runs, the transport is recorded in place of a mesh)
    send planes [int64, int32] that come back bit for bit, and the block
    of pack_runs / unpack_runs round-trips them."""
    from types import SimpleNamespace

    from radix_sort_tpu_torch.parallel import exchange

    n = 1000
    bits = _wide_column(n, 12)
    cols = (torch.from_numpy(bits).view(torch.float64),
            torch.arange(n, dtype=torch.int32))
    sent = []

    def record(planes, specs, counts, starts, mesh, capacity):
        sent.append(tuple(planes))
        return stream.planes_to_payloads(planes, specs), counts, False

    monkeypatch.setattr(exchange, "_exchange_once", record)
    mesh = SimpleNamespace(size=2)
    counts = torch.tensor([n, 0], dtype=torch.int32)
    got, _, _ = exchange.packed_all_to_all(cols, counts, counts * 0, mesh)
    dest = torch.from_numpy(np.random.default_rng(1).integers(
        0, 2, n).astype(np.int32))
    got2, _, _ = exchange.ragged_all_to_all(cols, dest, mesh)
    assert len(sent) == 2
    for planes in sent:
        assert [p.dtype for p in planes] == [torch.int64, torch.int32]
    np.testing.assert_array_equal(
        tdt.tensor_to_numpy(got[0]).view(np.int64), bits)
    order = np.argsort(dest.numpy(), kind="stable")
    np.testing.assert_array_equal(got2[1].numpy(), order)
    np.testing.assert_array_equal(
        tdt.tensor_to_numpy(got2[0]).view(np.int64), bits[order])
    # the block: 3 words a row, runs of odd length put the second run's
    # int64 plane at an odd word offset
    planes = sent[1]
    runs = [(0, 333), (333, 0), (333, n - 333)]
    block = exchange.pack_runs(planes, runs)
    assert block.dtype == torch.int32 and block.numel() == 3 * n
    assert exchange.words_per_row(planes) == 3
    back = exchange.unpack_runs(block, [c for _, c in runs],
                                (torch.int64, torch.int32))
    for a, b in zip(back, planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("count", [1, 333, 1000])
@pytest.mark.parametrize("order", ["i32_first", "i64_first"])
def test_unpack_runs_moves_int64_planes_at_odd_word_offsets(order, count):
    """One run's planes are views of the received block, but an int64
    plane that starts at an odd word offset (after an odd count of int32
    words) cannot be viewed as int64 there: unpack_runs copies that slice,
    and every plane comes back bit for bit."""
    from radix_sort_tpu_torch.parallel import exchange

    wide = torch.from_numpy(_wide_column(count, 13))
    narrow = torch.arange(count, dtype=torch.int32) * 7 - 5
    planes = ((narrow, wide, narrow.flip(0)) if order == "i32_first"
              else (wide, narrow, wide.flip(0)))
    kinds = tuple(p.dtype for p in planes)
    block = exchange.pack_runs(planes, [(0, count)])
    assert block.numel() == count * exchange.words_per_row(planes)
    back = exchange.unpack_runs(block, [count], kinds)
    for a, b in zip(back, planes):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # an offset in the received block, as a later source's run has
    shifted = torch.cat([torch.full((1,), -1, dtype=torch.int32), block])
    back = exchange.unpack_runs(shifted[1:], [count], kinds)
    for a, b in zip(back, planes):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wide_plane_checks():
    """An 8-byte plane is a payload: never a key or digit plane; it may
    share storage with a narrow key plane, which it is never taken for."""
    n = 300
    k32 = torch.arange(n, dtype=torch.int32).flip(0).contiguous()
    i64 = torch.arange(n, dtype=torch.int64) << 33
    with pytest.raises(ValueError, match="int32"):
        cr.sort_passes((i64,), (4,), (), 256, TILE)
    with pytest.raises(ValueError, match="int32"):
        cr.sort_passes((), (1,), (k32,), 256, TILE, digit=i64)
    with pytest.raises(ValueError):  # a 64-bit key's high word is int32
        cr.sort_passes((k32, i64), (4, 4), (), 256, TILE)
    with pytest.raises(ValueError):  # no float64 plane: its int64 bits
        cr.sort_passes((k32,), (4,), (i64.double(),), 256, TILE)
    outs, _ = cr.sort_passes((k32,), (4,), (i64,), 256, TILE)
    np.testing.assert_array_equal(outs[1].numpy(), i64.flip(0).numpy())
    buf = torch.arange(n, dtype=torch.int64)
    alias = buf.view(torch.uint8)[:n]  # the key plane, in buf's storage
    (ko, vo), _ = cr.sort_passes((alias,), (1,), (buf,), 256, TILE)
    order = np.argsort(alias.numpy(), kind="stable")
    np.testing.assert_array_equal(vo.numpy(), buf.numpy()[order])
    np.testing.assert_array_equal(ko.numpy(), alias.numpy()[order])


# ----------------------------------------- 8-byte planes on the card

def _wide_on(n: int, device, seed: int = 0):
    """An 8-byte plane of float64 bits on the card, and one that starts 8
    bytes past a 16-byte boundary (the row-by-row loads)."""
    col = torch.from_numpy(_wide_column(n + 1, seed)).to(device)
    return col[:n], col[1:]


@pytest.mark.cuda
@pytest.mark.parametrize("tile,threads", KERNEL_SHAPES)
@pytest.mark.parametrize("n", [1, 4097, (1 << 20) + 77, 1 << 24])
def test_cuda_wide_pass_kernel_both_modes_match_plain(cuda_device, n, tile,
                                                      threads):
    """The pass kernel's WIDE instance, look-back and base-table modes,
    against the plain version bit for bit: int32 and 8-byte planes mixed,
    an 8-byte plane off a 16-byte boundary among them."""
    k = _keys(n, "random", cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    w0, w1 = _wide_on(n, cuda_device)
    lb, bt, plain = _both_modes(k, (k, w0, iota, w1), 256, tile, 8,
                                threads)
    _assert_same(lb, plain)
    _assert_same(bt, plain)
    assert lb[0][1].dtype == torch.int64


@pytest.mark.cuda
@pytest.mark.parametrize("dist", ["random", "zeros", "tile_digit"])
def test_cuda_wide_pass_kernel_past_16_planes(cuda_device, dist):
    """20 planes, 8-byte ones in both launch groups: the look-back launch
    and a base-table launch each take the WIDE instance."""
    n = (1 << 20) + 77
    k = _keys(n, dist, cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    w0, w1 = _wide_on(n, cuda_device, seed=3)
    planes = (k,) + tuple((w0 + i, iota + i, w1 - i)[i % 3]
                          for i in range(19))
    before = dict(cr.launch_counts())
    lb, bt, plain = _both_modes(k, planes, 256, 4096, 0, 256)
    after = cr.launch_counts()
    assert after["onesweep_pass"] == before["onesweep_pass"] + 1
    assert after["rank_scatter"] == before["rank_scatter"] + 3
    # both groups of both modes hold an 8-byte plane
    assert after["wide_launches"] == before["wide_launches"] + 4
    _assert_same(lb, plain)
    _assert_same(bt, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["u8", "i16", "f16"])
def test_cuda_narrow_sort_kv_with_wide_payload(cuda_device, dtype):
    """A narrow key with 8-byte payloads (its WIDE instance: two CTAs an
    SM) on the card equals the same sort on the CPU, bit for bit, at a
    ragged n; a filled sort (one key) copies them."""
    d = np.dtype(NARROW[dtype])
    n = (1 << 21) + 5
    keys = _narrow_keys(d, n, 13)
    bits = _wide_column(n, 14)
    for ks in (keys, np.full(n, keys[7])):
        vals = (bits, np.arange(n, dtype=np.int32), bits.view(np.float64))
        g = rtt.sort_kv(tdt.tensor_from_numpy(ks, cuda_device),
                        tuple(tdt.tensor_from_numpy(v, cuda_device)
                              for v in vals))
        c = rtt.sort_kv(tdt.tensor_from_numpy(ks, "cpu"),
                        tuple(tdt.tensor_from_numpy(v, "cpu")
                              for v in vals))
        _bits_equal(g[0].cpu(), c[0])
        for a, b in zip(g[1], c[1]):
            _bits_equal(a.cpu(), b)


@pytest.mark.cuda
def test_cuda_wide_planes_counter_and_span(cuda_device):
    """A sort counts its 8-byte planes in launch_counts()["wide_planes"]
    and in its radix.sort_passes span's ``wide``, and the wide instance's
    launches in ``wide_launches``; a u32 KV sort counts none; a query's
    spans add up to the counter."""
    from radix_sort_tpu_torch.utils import profiling

    n = 1 << 20
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(0, 2**31, n).astype(np.int32)).to(
        cuda_device)
    iota = torch.arange(n, dtype=torch.int32, device=cuda_device)
    w0, _ = _wide_on(n, cuda_device)
    profiling.take_spans()
    profiling.enable()
    try:
        cr.reset_launch_counts()
        rtt.sort_kv(keys, iota)
        assert cr.launch_counts()["wide_planes"] == 0
        assert cr.launch_counts()["wide_launches"] == 0
        rtt.sort_kv(keys, (w0, iota, w0.view(torch.float64)))
        assert cr.launch_counts()["wide_planes"] == 2
        # one launch group, launched once a pass of the u32 key
        assert cr.launch_counts()["wide_launches"] == 4
        cr.reset_launch_counts()
        table = rtt.Table({"k": (keys % 5).to(torch.int16), "a": w0,
                           "b": w0 * 3, "c": iota})
        rtt.Query(table).filter("c", "ge", 7).group_by(
            "k", sa=("sum", "a"), sb=("sum", "b"), n=("count", None)
        ).sort_by("k").collect()
        torch.cuda.synchronize()
        counted = cr.launch_counts()["wide_planes"]
    finally:
        profiling.disable()
    spans = [s for s in profiling.take_spans()
             if s.name == "radix.sort_passes"]
    assert [s.attrs["wide"] for s in spans[:2]] == [0, 2]
    assert sum(s.attrs["wide"] for s in spans[2:]) == counted > 0
