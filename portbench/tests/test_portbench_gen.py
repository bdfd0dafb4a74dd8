"""The generators against the rules they copy, at small sizes."""

import numpy as np
import pytest
import torch

from portbench.gen import keys, seeds, tpch


def _np(t):
    if t.dtype == torch.uint32:
        return t.view(torch.int32).numpy().view(np.uint32)
    if t.dtype == torch.uint64:
        return t.view(torch.int64).numpy().view(np.uint64)
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


DTYPES = ["uint8", "int8", "int16", "uint16", "int32", "uint32", "int64",
          "uint64", "float16", "float32", "float64"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_key_distributions_follow_the_suite(dtype):
    n = 1000
    d = np.dtype(dtype)
    z = _np(keys.generate("Zeros", dtype, n, 1, "cpu"))
    assert z.dtype == d and not z.any()
    r = _np(keys.generate("Range", dtype, n, 1, "cpu"))
    ir = _np(keys.generate("InvertedRange", dtype, n, 1, "cpu"))
    if d.kind == "f":
        want = np.arange(n).astype(d)
    else:  # the dtype's minimum counting up, wrapping at its width
        want = (np.arange(n) + (np.iinfo(d).min if d.kind == "i" else 0)
                ).astype(d)
    assert np.array_equal(r, want) and np.array_equal(ir, want[::-1])
    rd = _np(keys.generate("RandomDistributed", dtype, n, 7, "cpu"))
    assert rd.dtype == d
    if d.kind == "f":
        assert rd[0] == -np.inf and rd[-1] == np.inf
        assert np.all(np.abs(rd[1:-1].astype(np.float64)) <= 1e9)
    else:
        assert rd[0] == np.iinfo(d).min and rd[-1] == np.iinfo(d).max
    rnd = _np(keys.generate("Random", dtype, n, 7, "cpu"))
    assert np.array_equal(rnd[1:-1], rd[1:-1])  # the same bits, unplanted
    assert len(np.unique(rnd)) > (50 if d.itemsize == 1 else n // 2)


def test_same_seed_same_keys_and_large_seeds():
    big = 2**31 + 12345
    a = keys.generate("RandomDistributed", "uint32", 4096, big, "cpu")
    b = keys.generate("RandomDistributed", "uint32", 4096, big, "cpu")
    c = keys.generate("RandomDistributed", "uint32", 4096, big + 1, "cpu")
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.equal(a.view(torch.int32), c.view(torch.int32))
    u = _np(a)
    assert u.min() == 0 and u.max() == 2**32 - 1
    # uniform over 32 bits: the top byte takes every value
    assert len(np.unique(u >> 24)) == 256
    assert seeds.stream(big, "x") != seeds.stream(big, "y")


def test_lineitem_follows_tpch_rules():
    n = 200_000
    c = {k: v.numpy() for k, v in tpch.lineitem(n, 10, 3, "cpu").items()}
    assert set(c) == set(tpch.COLUMNS)
    for k, dt in tpch.COLUMNS.items():
        assert c[k].dtype == torch.empty(0, dtype=dt).numpy().dtype
    qty = c["l_quantity"] // 100
    assert np.all(c["l_quantity"] % 100 == 0)
    assert qty.min() == 1 and qty.max() == 50
    assert c["l_discount"].min() == 0 and c["l_discount"].max() == 10
    assert c["l_tax"].min() == 0 and c["l_tax"].max() == 8
    # extendedprice = quantity * retailprice(partkey), retailprice in
    # [900.00, 2098.99]
    unit = c["l_extendedprice"] / qty
    assert np.all(c["l_extendedprice"] % qty == 0)
    assert unit.min() >= 90000 and unit.max() <= 90000 + 20000 + 99900
    pk = np.arange(1, 2_000_001)
    rp = 90000 + (pk // 10) % 20001 + 100 * (pk % 1000)
    assert np.isin(unit.astype(np.int64), rp).all()
    ship = c["l_shipdate"].astype(np.int64)
    assert ship.min() >= 8035 + 1 and ship.max() <= 10440 + 121
    flag = c["l_returnflag"]
    status = c["l_linestatus"]
    assert set(np.unique(flag)) == {ord("A"), ord("N"), ord("R")}
    assert np.all((status == ord("O")) == (ship > 9298))
    # N exactly where the receipt date (ship + 1..30) is past CURRENTDATE:
    # always N for ship > 9298, never for ship <= 9298 - 30
    assert np.all(flag[ship > 9298] == ord("N"))
    assert np.all(flag[ship <= 9298 - 30] != ord("N"))
    ra = flag[ship <= 9298 - 30]
    assert abs((ra == ord("R")).mean() - 0.5) < 0.01


def test_hurwitz_zeta_and_the_zipf_residue_law():
    from portbench.gen import zipf

    assert zipf.hurwitz_zeta(2.0, 1.0) == pytest.approx(np.pi**2 / 6,
                                                        rel=1e-14)
    q, s = 0.3, 1.3
    n = np.arange(10**6, dtype=np.float64)
    direct = ((q + n) ** -s).sum() + (q + 1e6) ** (1 - s) / (s - 1) \
        + (q + 1e6) ** -s / 2
    assert zipf.hurwitz_zeta(s, q) == pytest.approx(direct, rel=1e-12)
    p = zipf.residue_pmf(1.3, 4096)
    assert p.sum() == pytest.approx(1.0) and p[1] == pytest.approx(
        1 / zipf.hurwitz_zeta(1.3, 1.0), rel=1e-3)
    # numpy's own sampler, as BASELINE config 5 draws its probe keys
    ref = np.random.default_rng(5).zipf(1.3, 1 << 20) % 4096
    got = np.bincount(ref, minlength=4096) / ref.size
    assert np.abs(got[:8] - p[:8]).max() < 2e-3


def test_zipf_keys_by_seed_and_rank():
    from portbench.gen import zipf

    big = 2**33 + 5
    a = zipf.keys(1 << 20, 1.3, 4096, big, 2, "cpu")
    assert a.dtype == torch.uint32
    k = a.view(torch.int32)
    assert torch.equal(k, zipf.keys(1 << 20, 1.3, 4096, big, 2,
                                    "cpu").view(torch.int32))
    assert not torch.equal(k, zipf.keys(1 << 20, 1.3, 4096, big, 1,
                                        "cpu").view(torch.int32))
    assert not torch.equal(k, zipf.keys(1 << 20, 1.3, 4096, big + 1, 2,
                                        "cpu").view(torch.int32))
    assert 0 <= int(k.min()) and int(k.max()) < 4096
    assert 0.23 <= float((k == 1).double().mean()) <= 0.28
    n = 1 << 12  # the whole table again, each rank's rows as it made them
    whole = zipf.global_keys(n, 4, 1.3, 4096, big, "cpu").view(torch.int32)
    for r in range(4):
        assert torch.equal(whole[r * n:(r + 1) * n], zipf.keys(
            n, 1.3, 4096, big, r, "cpu").view(torch.int32))
