"""Each plain reference against a direct NumPy computation, and each
control against its reference (it has to come out wrong)."""

import numpy as np
import pytest
import torch

from portbench.gen import keys, tpch


@pytest.mark.parametrize("dtype", ["uint32", "int32", "uint64", "int64",
                                   "uint8", "float32", "float16"])
@pytest.mark.parametrize("payload", [None, "int32"])
def test_sort_reference_is_numpy_stable_sort(small_cell, dtype, payload):
    cell = small_cell("kvsort-u32-2p27", n=5000, payload=payload)
    cell.config["key_dtype"] = dtype
    ref = cell.reference
    inputs = cell.mix.make_inputs(cell, 11, torch.device("cpu"))
    exp = ref.expected(cell, inputs)
    k = inputs["keys"]
    host = (k.view(torch.int32).numpy().view(np.uint32)
            if k.dtype == torch.uint32 else
            k.view(torch.int64).numpy().view(np.uint64)
            if k.dtype == torch.uint64 else k.numpy())
    assert not (host == 0).any() or host.dtype.kind != "f"  # no -0.0 ties
    perm = np.argsort(host, kind="stable")
    bits = ref._bits(exp["keys"]).numpy()
    assert np.array_equal(bits, ref._bits(k).numpy()[perm])
    if payload:
        assert np.array_equal(exp["values"].numpy(), perm)
    assert ref.compare(cell, inputs, exp, exp) == {"keys_wrong": 0,
                                                   "values_wrong": 0}


def test_sort_control_breaks_the_order(small_cell):
    cell = small_cell("kvsort-u32-2p27", n=1 << 16)
    inputs = cell.mix.make_inputs(cell, 3, torch.device("cpu"))
    ref = cell.reference
    got = ref.compare(cell, inputs, ref.expected(cell, inputs),
                      ref.control(cell, inputs))
    assert got["keys_wrong"] > ref.LIMITS["keys_wrong"]


def _q1_numpy(cols, cutoff):
    keep = cols["l_shipdate"] <= cutoff
    c = {k: v[keep].astype(np.int64) for k, v in cols.items()}
    grp = c["l_returnflag"] * 256 + c["l_linestatus"]
    dp = c["l_extendedprice"] * (100 - c["l_discount"])
    ch = dp * (100 + c["l_tax"])
    out = {"grp": np.unique(grp)}
    rows = {k: [] for k in ("sum_qty", "sum_base_price", "sum_disc_price",
                            "sum_charge", "avg_qty", "avg_price", "avg_disc",
                            "count_order")}
    for g in out["grp"]:
        m = grp == g
        cnt = int(m.sum())
        sums = [int(c["l_quantity"][m].sum()),
                int(c["l_extendedprice"][m].sum()), int(dp[m].sum()),
                int(ch[m].sum())]
        for k, v in zip(("sum_qty", "sum_base_price", "sum_disc_price",
                         "sum_charge"), sums):
            rows[k].append(v)
        rows["avg_qty"].append(sums[0] / cnt)
        rows["avg_price"].append(sums[1] / cnt)
        rows["avg_disc"].append(int(c["l_discount"][m].sum()) / cnt)
        rows["count_order"].append(cnt)
    out.update({k: np.array(v) for k, v in rows.items()})
    return out


def test_q1_reference_is_numpy_group_by(small_cell):
    cell = small_cell("q1-sf10", lineitem_rows=50_000)
    inputs = cell.mix.make_inputs(cell, 21, torch.device("cpu"))
    exp = cell.reference.expected(cell, inputs)
    want = _q1_numpy({k: v.numpy() for k, v in inputs.items()},
                     10561 - 90)
    assert len(want["grp"]) == 4  # A-F, N-F, N-O, R-F
    for k, v in want.items():
        assert np.array_equal(exp[k], v), k
    assert all(v == 0 for v in cell.reference.compare(
        cell, inputs, exp, exp).values())


def test_q1_control_rounds_the_sums(small_cell):
    # a million rows: the charge sums pass 2^53, where float64 rounds
    cell = small_cell("q1-sf10", lineitem_rows=1 << 20)
    inputs = cell.mix.make_inputs(cell, 22, torch.device("cpu"))
    ref = cell.reference
    got = ref.compare(cell, inputs, ref.expected(cell, inputs),
                      ref.control(cell, inputs))
    assert got["sums_wrong"] > ref.LIMITS["sums_wrong"]


def _dist_inputs(n=1 << 14):
    """The dist cell's inputs for a world of one rank, and its answer
    worked out here with NumPy."""
    from types import SimpleNamespace

    from portbench import spec

    cell = spec.cell("dist-query-4x2p28")
    cell.config["rows_per_rank"] = n
    one = SimpleNamespace(rank=0, size=1, gather=lambda o: [o],
                          all_reduce=lambda t: t)
    inputs = cell.mix.make_inputs(cell, 2**31 + 3, torch.device("cpu"), one)
    k = inputs["k"].view(torch.int32).numpy().astype(np.int64)
    order = np.argsort(k, kind="stable")
    uk, cnt = np.unique(k, return_counts=True)
    kt = inputs["k"]
    ans = {"join_k": kt.clone(), "join_k_r": kt.clone(),
           "join_pv": inputs["pv"].clone(),
           "join_bv": torch.from_numpy((k * 7).astype(np.int32)),
           "match_count": torch.tensor(n, dtype=torch.int32),
           "join_overflow": torch.tensor(False), "agg_k": uk, "agg_n": cnt,
           "sort_k": torch.from_numpy(k[order].astype(np.int32)).view(
               torch.uint32),
           "sort_v": torch.from_numpy(order.astype(np.int32)),
           "sort_overflow": False}
    return cell, inputs, ans


def test_dist_reference_passes_the_answer_and_fails_each_fault():
    cell, inputs, ans = _dist_inputs()
    ref = cell.reference
    exp = ref.expected(cell, inputs)
    assert ref.compare(cell, inputs, exp, ans) == dict.fromkeys(ref.LIMITS,
                                                                0)

    def broken(**change):
        got = ref.compare(cell, inputs, exp, {**ans, **change})
        return {k for k, v in got.items() if v > 0}

    k, v = ans["sort_k"].view(torch.int32), ans["sort_v"]
    i = int(torch.nonzero(k[1:] == k[:-1])[0])  # two rows of one key
    swapped = v.clone()
    swapped[i], swapped[i + 1] = v[i + 1], v[i]
    assert broken(sort_v=swapped) == {"sort_wrong"}
    assert broken(sort_k=ans["sort_k"][:-1],
                  sort_v=ans["sort_v"][:-1]) == {"sort_wrong"}
    # a joined row id twice and another not at all, both of one key
    jk = ans["join_k"].view(torch.int32)
    a, b = torch.nonzero(jk == 1)[:2, 0].tolist()
    pv = ans["join_pv"].clone()
    pv[b] = pv[a]
    assert broken(join_pv=pv) == {"join_rows_wrong"}
    bv = ans["join_bv"].clone()
    bv[5] += 7
    assert broken(join_bv=bv) == {"join_rows_wrong"}
    assert broken(match_count=torch.tensor(len(pv) - 1)) == {
        "join_match_wrong"}
    n = ans["agg_n"].copy()
    n[0] += 1
    assert broken(agg_n=n) == {"counts_wrong"}


def test_dist_control_counts_round_past_2_to_the_24():
    """The control's float32 counts: 2^25 rows of one key count 2^24."""
    from portbench import spec

    ref = spec.cell("dist-query-4x2p28").reference
    keys = torch.ones(1 << 25, dtype=torch.int32).view(torch.uint32)
    k, n = ref.float32_counts(keys, 4096)
    assert k.tolist() == [1] and n.tolist() == [1 << 24]
    exp = {"counts": torch.bincount(torch.ones(1 << 25, dtype=torch.int64),
                                    minlength=4096)}
    assert ref._counts(exp, {}, {"agg_k": k, "agg_n": n}) == {
        "counts_wrong": 1}
