"""A whole sort or partition in one call: ``cuda_radix.sort_passes``.

On a card ``sort_passes`` enqueues every launch of a sort (the memset of
its workspace, ``pass_histograms`` and each pass's ``onesweep_pass``) with
one call into the kernel library, ``rst_sort_planes``; on this CPU it runs
its plain version, the per-pass loop through the module's wrappers.  The
CPU tests drive it through ``sort`` / ``sort_kv`` / ``argsort`` and
``stream.partition_planes`` and hold the results bit for bit (tolerance
0) against the JAX package's, with no host read and no result sharing
storage with an input.  The tests marked ``cuda`` hold ``sort_passes`` on
the card bit for bit against the per-pass launches (``sort_passes_plain``:
``pass_histograms`` + one ``onesweep_pass`` a pass with its ``PassPlan``)
over the same cases, with the same launch counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radix_sort_tpu as rst
import radix_sort_tpu_torch as rtt
from radix_sort_tpu.ops import partition as jpart
from radix_sort_tpu_torch import _build, dtypes as tdt
from radix_sort_tpu_torch.ops import cuda_radix as cr, stream

TILE = rtt.DEFAULT_CONFIG.tile_elems  # the sort's tile
SIZES = (2 * TILE + 5, 3001)
DTYPES = {"u32": np.uint32, "u64": np.uint64, "i32": np.int32,
          "f32": np.float32, "u8": np.uint8, "i8": np.int8,
          "f16": np.float16}
# "Constant": one key, 0x5A in every byte, so one digit fills every pass
DISTS = ("Zeros", "Range", "InvertedRange", "RandomDistributed", "Constant")
# 17 payload planes make a second plane group; "17w": 17 of which 8 are
# int64 (float64 bits among them), in both groups
PAYLOADS = (0, 1, 17, "17w")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _keys(dtype: str, dist: str, n: int) -> np.ndarray:
    """``datasets`` keys; float16 RandomDistributed keys are uint16 ones'
    bits (NaNs, infinities and subnormals among them), since its value
    range overflows float16."""
    d = np.dtype(DTYPES[dtype])
    if dist == "Constant":
        return np.frombuffer(b"\x5a" * (n * d.itemsize), d).copy()
    if dtype == "f16" and dist == "RandomDistributed":
        return rtt.datasets.RandomDistributed(np.uint16, seed=3).generate(
            n).view(np.float16)
    return {ds.name: ds for ds in rtt.datasets.make_datasets(d, 3)}[
        dist].generate(n)


def _payloads(npay, n: int) -> list:
    if npay == "17w":
        rng = np.random.default_rng(170)
        f = rng.standard_normal(n)
        f[::7] = np.array([np.nan, -0.0, 0.0, -np.nan, np.inf, -np.inf,
                           1.0])[np.arange(f[::7].size) % 7]
        return [np.arange(n, dtype=np.int32)] + [
            (f + i).view(np.int64) if i % 4 == 1 else
            rng.integers(-2**63, 2**63 - 1, n) if i % 4 == 3 else
            rng.integers(-2**31, 2**31, n).astype(np.int32)
            for i in range(1, 17)]
    rng = np.random.default_rng(npay)
    return [np.arange(n, dtype=np.int32)] + [
        rng.integers(-2**31, 2**31, n).astype(np.int32)
        for _ in range(npay - 1)]


def _bits_equal(a, b) -> None:
    a = a if isinstance(a, np.ndarray) else tdt.tensor_to_numpy(a)
    np.testing.assert_array_equal(a.view(np.uint8),
                                  np.asarray(b).view(np.uint8))


def _own_storage(outs, ins) -> None:
    """No output tensor shares storage with an input."""
    held = {t.untyped_storage().data_ptr() for t in ins if t.numel()}
    for t in outs:
        if t.numel():
            assert t.untyped_storage().data_ptr() not in held


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("npay", PAYLOADS)
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sort_entry_matches_jax(dtype, dist, npay, n, monkeypatch):
    """sort and argsort (no payload) or sort_kv: one sort_passes call a
    sort, no host read, results in storage of their own, keys and
    payloads bit for bit the JAX package's."""
    keys = _keys(dtype, dist, n)
    spy = _Spy(cr.sort_passes)
    monkeypatch.setattr(cr, "sort_passes", spy)
    reads = stream.host_reads
    tk = tdt.tensor_from_numpy(keys, "cpu")
    jk = jnp.asarray(keys)
    if npay == 0:
        ko, perm = rtt.sort(tk), rtt.argsort(tk)
        assert spy.calls == 2
        _bits_equal(ko, rst.sort(jk))
        np.testing.assert_array_equal(perm.numpy(),
                                      np.asarray(rst.argsort(jk)))
        _own_storage((ko, perm), (tk,))
    else:
        vals = _payloads(npay, n)
        tv = tuple(torch.from_numpy(v) for v in vals)
        ko, vo = rtt.sort_kv(tk, tv)
        assert spy.calls == 1
        jko, jvo = rst.sort_kv(jk, tuple(jnp.asarray(v) for v in vals))
        _bits_equal(ko, jko)
        for a, b in zip(vo, jvo):
            _bits_equal(a, b)
        _own_storage((ko,) + tuple(vo), (tk,) + tv)
    assert stream.host_reads == reads


def _partition_planes(pay: str, n: int, rng) -> tuple:
    """An iota and an int32 plane, or an iota and an 8-byte one."""
    if pay == "int64":
        return (np.arange(n, dtype=np.int32),
                rng.integers(-2**63, 2**63 - 1, n))
    return (np.arange(n, dtype=np.int32),
            rng.integers(-2**31, 2**31, n).astype(np.int32))


@pytest.mark.parametrize("pay", ["int32", "int64"])
@pytest.mark.parametrize("ids_kind", ["random", "one_bucket"])
@pytest.mark.parametrize("num_buckets", [2, 256, 1000])
@pytest.mark.parametrize("n", SIZES)
def test_partition_entry_matches_jax(n, num_buckets, ids_kind, pay,
                                     monkeypatch):
    """partition_planes: one sort_passes call (the ids as a digit plane
    that does not move up to 256 buckets, two moving 8-bit passes for
    1000), no host read, new storage, the planes (int32, or an 8-byte one)
    and the counts equal the JAX stable partition's."""
    rng = np.random.default_rng(num_buckets)
    ids = (rng.integers(0, num_buckets, n) if ids_kind == "random"
           else np.full(n, num_buckets // 3)).astype(np.int32)
    planes = _partition_planes(pay, n, rng)
    spy = _Spy(cr.sort_passes)
    monkeypatch.setattr(cr, "sort_passes", spy)
    reads = stream.host_reads
    tids = torch.from_numpy(ids)
    tp = tuple(torch.from_numpy(p) for p in planes)
    outs, counts = stream.partition_planes(tids, tp, num_buckets)
    assert spy.calls == 1 and stream.host_reads == reads
    jo, jc, _ = jpart.stable_partition(
        jnp.asarray(ids), tuple(jnp.asarray(p) for p in planes), num_buckets,
        method="sort")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for a, b in zip(outs, jo):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _own_storage(outs, (tids,) + tp)


def _sort_args(dtype: str, dist: str, npay: int, n: int, device):
    """sort_passes' (key planes, passes, payload planes, kind) for a sort
    of ``_keys`` at radix 256, as the sort entry points build them."""
    tk = tdt.tensor_from_numpy(_keys(dtype, dist, n), device)
    d = tdt.key_dtype(tk.dtype)
    pays = tuple(torch.from_numpy(v).to(device) for v in _payloads(npay, n))
    if d.itemsize < 4:
        return (tdt.as_container(tk),), (d.itemsize,), pays, d.kind
    kp = stream.key_word_planes(tdt.to_sortable(tk))
    return kp, (4,) * len(kp), pays, "u"


@pytest.mark.parametrize("npay", PAYLOADS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sort_passes_plain_is_the_plain_torch_loop(dtype, npay):
    """On the CPU sort_passes is its plain version; the loop through the
    wrappers equals the one that calls the plain torch versions itself
    (``torch_only``, chip_smoke.py's reference on the card), and neither
    counts a launch."""
    keys, passes, pays, kind = _sort_args(dtype, "RandomDistributed", npay,
                                          3001, "cpu")
    before = cr.launch_counts()
    outs, table = cr.sort_passes(keys, passes, pays, 256, TILE, kind=kind)
    want, wtable = cr.sort_passes_plain(keys, passes, pays, 256, TILE,
                                        kind=kind, torch_only=True)
    assert cr.launch_counts() == before
    torch.testing.assert_close(table, wtable, rtol=0, atol=0)
    for a, b in zip(outs, want):
        _bits_equal(a, b.numpy())
    _own_storage(outs, keys + pays)


def test_sort_passes_refuses_bad_planes():
    """The planes are checked once, before anything runs."""
    n = 100
    k8 = torch.zeros(n, dtype=torch.uint8)
    k32 = torch.zeros(n, dtype=torch.int32)
    alias = torch.zeros(4 * n, dtype=torch.uint8)
    with pytest.raises(ValueError, match="aliases the narrow key plane"):
        cr.sort_passes((alias[:n],), (1,), (alias.view(torch.int32),), 256,
                       TILE)
    with pytest.raises(ValueError, match="length"):
        cr.sort_passes((k32,), (4,), (k32[:50],), 256, TILE)
    with pytest.raises(ValueError, match="int32"):
        cr.sort_passes((), (1,), (k32,), 256, TILE, digit=k8)
    with pytest.raises(ValueError, match="key planes' place"):
        cr.sort_passes((k32,), (1,), (), 256, TILE, digit=k32)
    with pytest.raises(ValueError, match="do not fit"):
        cr.sort_passes((k8,), (2,), (), 256, TILE)


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("npay", PAYLOADS)
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sort_passes_matches_per_pass_launches(dtype, dist, npay, n,
                                               cuda_device):
    """One rst_sort_planes call against the per-pass launches on the same
    card tensors: OUT and the pass table bit for bit, and the launch
    counters advance by the same counts."""
    keys, passes, pays, kind = _sort_args(dtype, dist, npay, n, cuda_device)
    c0 = {**cr.launch_counts(), **cr.narrow_launch_counts()}
    outs, table = cr.sort_passes(keys, passes, pays, 256, TILE, kind=kind)
    c1 = {**cr.launch_counts(), **cr.narrow_launch_counts()}
    want, wtable = cr.sort_passes_plain(keys, passes, pays, 256, TILE,
                                        kind=kind)
    c2 = {**cr.launch_counts(), **cr.narrow_launch_counts()}
    assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
    torch.testing.assert_close(table, wtable, rtol=0, atol=0)
    for a, b in zip(outs, want):
        _bits_equal(a, tdt.tensor_to_numpy(b))
    _own_storage(outs, keys + pays)


@pytest.mark.cuda
@pytest.mark.parametrize("pay", ["int32", "int64"])
@pytest.mark.parametrize("ids_kind", ["random", "one_bucket"])
@pytest.mark.parametrize("num_buckets", [2, 256, 1000])
@pytest.mark.parametrize("n", SIZES)
def test_partition_passes_match_per_pass_launches(n, num_buckets, ids_kind,
                                                  pay, cuda_device):
    """A partition's sort_passes (the ids a digit plane that does not move
    up to 256 buckets, else two moving passes) against the per-pass
    launches, with the same launch counts, int32 planes or an 8-byte one
    among them."""
    rng = np.random.default_rng(num_buckets)
    ids = torch.from_numpy((rng.integers(0, num_buckets, n)
                            if ids_kind == "random"
                            else np.full(n, num_buckets // 3)).astype(
                                np.int32)).to(cuda_device)
    planes = tuple(torch.from_numpy(p).to(cuda_device)
                   for p in _partition_planes(pay, n, rng))
    radix = max(2, stream._next_pow2(num_buckets))
    if radix <= 256:
        args = ((), (1,), planes, radix, TILE)
        kw = {"digit": ids}
    else:
        args = ((ids,), (2,), planes, 256, TILE)
        kw = {}
    c0 = cr.launch_counts()
    outs, table = cr.sort_passes(*args, **kw)
    c1 = cr.launch_counts()
    want, wtable = cr.sort_passes_plain(*args, **kw)
    c2 = cr.launch_counts()
    assert {k: c1[k] - c0[k] for k in c0} == {k: c2[k] - c1[k] for k in c0}
    torch.testing.assert_close(table, wtable, rtol=0, atol=0)
    for a, b in zip(outs, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _own_storage(outs, (ids,) + planes)
    if pay == "int64":
        assert c1["wide_planes"] - c0["wide_planes"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nplanes", [1, 16, 17, 40])
@pytest.mark.parametrize("passes", [1, 4, 8, 64])
@pytest.mark.parametrize("n", [1, 3001, 1 << 20, (1 << 30) + 5])
def test_sort_workspace_bytes_matches_the_layout(n, passes, nplanes,
                                                 cuda_device):
    """rst_sort_workspace_bytes is the layout sort_passes allocates and
    reads its table from: the (P, R) table rounded to 16 bytes, P
    look-back scratch rows, and the (R, B) tile bases past 16 planes."""
    lib = _build.lib()
    for radix in (2, 16, 256):
        table = -(-4 * passes * radix // 16) * 16
        rows = passes * lib.rst_onesweep_scratch_bytes(n, TILE, radix)
        bases = 4 * radix * -(-n // TILE) if nplanes > 16 else 0
        assert lib.rst_sort_workspace_bytes(n, TILE, radix, passes,
                                            nplanes) == table + rows + bases


@pytest.mark.cuda
def test_sort_passes_runs_without_a_host_sync(cuda_device):
    """A u32 KV sort, a narrow one and a partition under
    set_sync_debug_mode("error"): sort_passes reads nothing back."""
    cases = [_sort_args("u32", "RandomDistributed", 1, 1 << 20, cuda_device),
             _sort_args("f16", "RandomDistributed", 17, 1 << 20,
                        cuda_device)]
    ids = torch.randint(0, 200, (1 << 20,), dtype=torch.int32,
                        device=cuda_device)
    torch.cuda.synchronize()
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [cr.sort_passes(k, p, pl, 256, TILE, kind=kind)
               for k, p, pl, kind in cases]
        part = cr.sort_passes((), (1,), (ids,), 256, TILE, digit=ids)
    finally:
        torch.cuda.set_sync_debug_mode(old)
    for (k, p, pl, kind), (outs, _) in zip(cases, got):
        want, _ = cr.sort_passes_plain(k, p, pl, 256, TILE, kind=kind)
        for a, b in zip(outs, want):
            _bits_equal(a, tdt.tensor_to_numpy(b))
    torch.testing.assert_close(part[0][0], torch.sort(ids, stable=True)
                               .values, rtol=0, atol=0)
