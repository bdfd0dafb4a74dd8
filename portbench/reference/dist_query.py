"""The plain reference of the distributed join, aggregate and sort, in
plain PyTorch and ``torch.distributed`` on the harness's own group.

Every rank makes the whole probe table again from the seed on its card
(``inputs["global_keys"]``: N = ranks * rows_per_rank keys, row i's key
K[i], 4 GiB at the cell's size), so each row an answer holds is checked
against the row it claims to be, by its global id ``pv``.  The answer is
exact, and every limit 0:

- ``join_match_wrong``: |match_count - N|, the overflow flag, and
  |rows joined over every rank - N|: one match a probe row;
- ``join_rows_wrong``: joined rows whose ``pv`` is no row id, whose key
  is not K[pv], whose right key differs or whose ``bv`` is not 7 k; keys
  whose joined count is not their count in K; and 1 where the joined row
  ids are not each id once (their sum, and the sum of a bijective hash of
  them, against those of 0..N-1);
- ``counts_wrong``: the groups (of ``modulus`` keys) whose count differs
  from K's, a key missing or doubled included, on the worst rank's copy;
- ``sort_wrong``: sorted rows whose ``pv`` is no row id or whose key is
  not K[pv]; neighbouring rows, on a rank or across two ranks, whose
  (key, pv) does not rise (the sort is stable: equal keys in global row
  order); |rows over every rank - N|; the overflow flag.  Rising
  (key, pv) pairs that are (K[pv], pv) and N in number are each row once,
  in stable order.

Each sum over ranks goes through ``inputs["ranks"]`` (the harness's gloo
group; None for one process); every rank calls ``expected`` and
``compare`` in the same order.  Checks run in blocks of rows, so the
temporaries stay small beside the answers kept.

The control puts this reference in the program's place, with the
aggregate's counts in float32 (each rank adds ones into float32 counts
and the ranks' counts are summed in float32): a count past 2^24 rounds,
and the cell's most frequent key holds ~2.7e8 rows.  Its join keeps each
rank's own rows (any placement meets the checks) and its sort is a
stable ``torch.sort`` of K, each rank keeping its layout's rows."""

from __future__ import annotations

import numpy as np
import torch

LIMITS = {"join_match_wrong": 0, "join_rows_wrong": 0, "counts_wrong": 0,
          "sort_wrong": 0}
BLOCK = 1 << 26
_MASK32 = 0xFFFFFFFF
_HASH = 0x9E3779B97F4A7C15 - (1 << 64)  # odd: x -> x * _HASH is a bijection


def _gather(inputs: dict, obj) -> list:
    ranks = inputs.get("ranks")
    return [obj] if ranks is None else ranks.gather(obj)


def _u64(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32) values as int64 in [0, 2^32)."""
    return t.view(torch.int32).to(torch.int64) & _MASK32


def _id_sums(pv: torch.Tensor) -> tuple:
    """(sum of ids, sum of their hash), both modulo 2^64."""
    return (int(pv.sum()) % (1 << 64),
            int((pv * _HASH).sum()) % (1 << 64))


def _blocks(n: int):
    for lo in range(0, n, BLOCK):
        yield lo, min(n, lo + BLOCK)


def expected(cell, inputs: dict) -> dict:
    """K and its key counts.  Raises where the keys made again differ from
    the rank's own shard: that is the benchmark's fault, not the
    program's."""
    K = inputs["global_keys"]().view(torch.int32)
    n = inputs["rows_per_rank"]
    rank = 0 if inputs.get("ranks") is None else inputs["ranks"].rank
    if not torch.equal(K[rank * n:(rank + 1) * n],
                       inputs["k"].view(torch.int32)):
        raise RuntimeError("the probe keys made again from the seed differ "
                           "from the rank's inputs")
    M = cell.config["probe_key"]["modulus"]
    counts = torch.zeros(M, dtype=torch.int64, device=K.device)
    for lo, hi in _blocks(K.shape[0]):
        counts += torch.bincount(_u64(K[lo:hi]), minlength=M)
    N = K.shape[0]
    sums = [0, 0]
    for lo, hi in _blocks(N):
        s = _id_sums(torch.arange(lo, hi, dtype=torch.int64,
                                  device=K.device))
        sums = [(a + b) % (1 << 64) for a, b in zip(sums, s)]
    return {"K": K, "N": N, "counts": counts, "id_sums": tuple(sums),
            "factor": cell.config["build_value_factor"]}


def _rows_at(exp: dict, k: torch.Tensor, pv: torch.Tensor):
    """Rows (k as int64, pv as int64) that are no row of K: pv out of
    range or k != K[pv]."""
    N, K = exp["N"], exp["K"]
    in_range = (pv >= 0) & (pv < N)
    kk = _u64(K[pv.clamp(0, N - 1)])
    return ~in_range | (k != kk)


def _join(exp: dict, inputs: dict, ans: dict) -> dict:
    M = exp["counts"].shape[0]
    rows = ans["join_k"].shape[0]
    bad = 0
    jc = torch.zeros(M + 1, dtype=torch.int64, device=exp["K"].device)
    sums = [0, 0]
    for lo, hi in _blocks(rows):
        k = _u64(ans["join_k"][lo:hi])
        pv = ans["join_pv"][lo:hi].to(torch.int64)
        wrong = (_rows_at(exp, k, pv)
                 | (_u64(ans["join_k_r"][lo:hi]) != k)
                 | (ans["join_bv"][lo:hi].to(torch.int64)
                    != k * exp["factor"]))
        bad += int(wrong.sum())
        jc += torch.bincount(k.clamp(max=M), minlength=M + 1)
        s = _id_sums(pv)
        sums = [(a + b) % (1 << 64) for a, b in zip(sums, s)]
    got = _gather(inputs, {"bad": bad, "rows": rows, "sums": sums,
                           "jc": jc.cpu()})
    N = exp["N"]
    total = sum(g["rows"] for g in got)
    jc = sum(g["jc"] for g in got)
    sums = tuple(sum(g["sums"][i] for g in got) % (1 << 64) for i in (0, 1))
    keys_off = int((jc[:M] != exp["counts"].cpu()).sum()) + int(jc[M])
    match_wrong = (abs(int(ans["match_count"]) - N)
                   + int(bool(ans["join_overflow"])) + abs(total - N))
    return {"join_match_wrong": match_wrong,
            "join_rows_wrong": sum(g["bad"] for g in got) + keys_off
            + int(sums != exp["id_sums"])}


def _counts(exp: dict, inputs: dict, ans: dict) -> dict:
    want = exp["counts"].cpu()
    M = want.shape[0]
    k = torch.from_numpy(np.asarray(ans["agg_k"]).astype(np.int64))
    n = torch.from_numpy(np.asarray(ans["agg_n"]).astype(np.int64))
    got = torch.zeros(M, dtype=torch.int64)
    seen = torch.zeros(M + 1, dtype=torch.int64)
    if k.shape != n.shape:
        wrong = M
    else:
        inside = (k >= 0) & (k < M)
        got.index_add_(0, k[inside], n[inside])
        seen.index_add_(0, torch.where(inside, k, M), torch.ones_like(k))
        wrong = (int((got != want).sum()) + int((seen[:M] > 1).sum())
                 + int(seen[M]))
    return {"counts_wrong": max(_gather(inputs, wrong))}


def _sort(exp: dict, inputs: dict, ans: dict) -> dict:
    ks, vs = ans["sort_k"], ans["sort_v"]
    rows = ks.shape[0]
    bad = 0
    prev = None
    ends = None
    if vs.shape[0] != rows:
        bad, rows = rows + vs.shape[0], 0
    for lo, hi in _blocks(rows):
        k = _u64(ks[lo:hi])
        pv = vs[lo:hi].to(torch.int64)
        bad += int(_rows_at(exp, k, pv).sum())
        # (key, pv) as one int64: k < 2^32, pv < 2^31 for a row id
        kv = (k << 31) | (pv & ((1 << 31) - 1))
        if prev is not None:
            kv = torch.cat([prev, kv])
        bad += int((kv[1:] <= kv[:-1]).sum())
        prev = kv[-1:]
        first = kv[:1] if ends is None else ends[0]
        ends = (first, kv[-1:])
    edge = None if ends is None else (int(ends[0]), int(ends[1]))
    got = _gather(inputs, {"bad": bad, "rows": rows, "edge": edge})
    edges = [g["edge"] for g in got if g["edge"] is not None]
    across = sum(a[1] >= b[0] for a, b in zip(edges, edges[1:]))
    total = sum(g["rows"] for g in got)
    return {"sort_wrong": sum(g["bad"] for g in got) + across
            + abs(total - exp["N"]) + int(bool(ans["sort_overflow"]))}


def compare(cell, inputs: dict, expected: dict, answer: dict) -> dict:
    out = _join(expected, inputs, answer)
    out.update(_counts(expected, inputs, answer))
    out.update(_sort(expected, inputs, answer))
    return out


def float32_counts(keys: torch.Tensor, modulus: int, ranks=None):
    """The control's group-by count: ones added into float32 counts on
    each rank, the ranks' counts summed in float32 (``ranks``, or one
    process).  Returns the keys present and their counts, as numpy."""
    counts = torch.zeros(modulus, dtype=torch.float32, device=keys.device)
    counts.index_add_(0, _u64(keys), torch.ones(
        keys.shape[0], dtype=torch.float32, device=keys.device))
    counts = counts.cpu()
    if ranks is not None:
        counts = ranks.all_reduce(counts)
    present = torch.nonzero(counts > 0).reshape(-1)
    return present.numpy(), counts[present].to(torch.int64).numpy()


def control(cell, inputs: dict) -> dict:
    k, pv = inputs["k"], inputs["pv"]
    dev = k.device
    M = cell.config["probe_key"]["modulus"]
    # the join: each rank's own rows against the whole build side
    order = torch.argsort(_u64(inputs["bk"]))
    bk, bv = _u64(inputs["bk"])[order], inputs["bv"][order]
    k64 = _u64(k)
    at = torch.searchsorted(bk, k64).clamp(max=bk.shape[0] - 1)
    hit = bk[at] == k64
    matched = torch.tensor([int(hit.sum())], dtype=torch.int64)
    matched = sum(_gather(inputs, matched))
    agg_k, agg_n = float32_counts(k, M, inputs.get("ranks"))
    # the sort: a stable sort of every key, this rank's rows of it
    vals, idx = torch.sort(inputs["global_keys"]().view(torch.int32),
                           stable=True)
    n = inputs["rows_per_rank"]
    ranks = inputs.get("ranks")
    r = 0 if ranks is None else ranks.rank
    joined = k.view(torch.int32)[hit].view(torch.uint32)
    return {"join_k": joined, "join_pv": pv[hit], "join_bv": bv[at][hit],
            "join_k_r": joined.clone(),
            "match_count": torch.tensor(int(matched[0]), dtype=torch.int32),
            "join_overflow": torch.tensor(False),
            "agg_k": agg_k, "agg_n": agg_n,
            "sort_k": vals[r * n:(r + 1) * n].view(torch.uint32).clone(),
            "sort_v": idx[r * n:(r + 1) * n].to(torch.int32),
            "sort_overflow": False}
