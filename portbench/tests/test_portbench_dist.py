"""The four-card cell on the CPU: four gloo ranks of the many-rank path
(``launch.py``) at 2^16 rows a rank, the harness's look for cards
skipped.  A sound run is correct and has the contract's keys; runs with
the timed path broken underneath on one rank (a row dropped, the input
handed back as the sort, a count off by one) or on every rank (the
exchange between ranks left out) are not; a rank that raises ends the run
with no result, quickly.  Faults are planted in each rank by a
``prelude`` of this module, which the spawned ranks import by name."""

import time

import pytest
import torch

from portbench import launch, spec

CELL = "dist-query-4x2p28"
ROWS = 1 << 16
SEED = 2**33 + 17


def small():
    cell = spec.cell(CELL)
    cell.config["rows_per_rank"] = ROWS
    return cell


def run(prelude=None, trace=False, program="port", seconds=0.5,
        timeout_s=240.0):
    return launch.launch(small(), {"seed": SEED, "seconds": seconds,
                                   "trace": trace, "program": program},
                         time.time(), {"seed": SEED}, device="cpu",
                         backend="gloo", timeout_s=timeout_s,
                         prelude=prelude)


def fault(rank, kind):
    """Plant ``kind`` in this rank's program before the run."""
    from radix_sort_tpu_torch.parallel import dist_ops, dist_sort, exchange

    sort = dist_sort.dist_sort_kv
    if kind == "drop_last_row" and rank == 1:
        def dist_sort_kv(*a, **kw):
            ks, vs, over = sort(*a, **kw)
            return ks[:-1], vs[:-1], over
        dist_sort.dist_sort_kv = dist_sort_kv
    elif kind == "input_as_sort" and rank == 2:
        def dist_sort_kv(keys, values, **kw):
            sort(keys, values, **kw)  # its collectives still run
            return keys, values, False
        dist_sort.dist_sort_kv = dist_sort_kv
    elif kind == "count_off_by_one" and rank == 3:
        agg = dist_ops.dist_hash_aggregate

        def dist_hash_aggregate(*a, **kw):
            table, over = agg(*a, **kw)
            n = table.columns["n"].clone()
            n[0] += 1
            table.columns["n"] = n
            return table, over
        dist_ops.dist_hash_aggregate = dist_hash_aggregate
    elif kind == "no_exchange":
        def all_to_all_chunks(planes, counts, starts, mesh, num_chunks=1,
                              capacity=None):
            def chunks():  # each rank keeps the rows it would send itself
                for g in range(num_chunks):
                    i = g * mesh.size + mesh.rank
                    lo, c = int(starts[i]), int(counts[i])
                    got = torch.zeros(mesh.size, dtype=torch.int32)
                    got[mesh.rank] = c
                    yield g, tuple(p[lo:lo + c] for p in planes), got
            return False, chunks()
        exchange.all_to_all_chunks = all_to_all_chunks
    elif kind == "raise" and rank == 2:
        calls = []

        def dist_sort_kv(*a, **kw):
            calls.append(1)
            if len(calls) > 3:  # in the window, past the warm-up
                raise RuntimeError("a rank fails")
            return sort(*a, **kw)
        dist_sort.dist_sort_kv = dist_sort_kv


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_has_the_contract_keys(trace):
    rc, line = run(trace=trace)
    assert rc == 0 and line["correct"] and line["failed"] == 0
    assert line["attempted"] > 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert line["device"]["count"] == 4
    cell = small()
    wanted = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted
    assert all(v["value"] == 0 for v in line["checks"].values())
    if trace:
        # gloo ranks run no NCCL kernel: exchange_device_ms reads nothing
        assert set(line["metrics"]) == wanted - {"exchange_device_ms"}
        assert line["metrics"]["rank_imbalance"]["value"] >= 1.0
        assert line["metrics"]["host_reads_per_call"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(line["device"])
        ops = line["breakdown"]["device_ops"]
        assert ops and all(n.startswith("rank ") for n, _ in ops)
    else:
        assert set(line["metrics"]) == wanted


@pytest.mark.parametrize("kind,check", [
    ("drop_last_row", "sort_wrong"), ("input_as_sort", "sort_wrong"),
    ("count_off_by_one", "counts_wrong"), ("no_exchange", None)])
def test_broken_run_is_not_correct(kind, check):
    rc, line = run(prelude=(fault, kind))
    assert rc == 0 and not line["correct"] and line["failed"] > 0
    bad = {k for k, v in line["checks"].items() if v["value"] > v["limit"]}
    assert bad if check is None else check in bad


def test_a_rank_that_raises_ends_the_run_with_no_result(capsys):
    t = time.time()
    rc, line = run(prelude=(fault, "raise"), seconds=30.0, timeout_s=120.0)
    assert rc != 0 and line is None
    assert time.time() - t < 60.0  # well before the window would end
    assert "rank 2" in capsys.readouterr().err


def test_the_control_at_a_small_size_differs_only_in_its_counts():
    """Float32 counts are exact below 2^24 rows a key, so at 2^16 rows a
    rank the control's join and sort are held to the same checks and pass
    (its counting fails at a size past 2^24:
    test_portbench_reference.py); on the card, at the cell's size, it is
    not correct."""
    rc, line = run(program="control")
    assert rc == 0 and line["correct"]


def test_fewer_cards_than_the_cell_needs_exits_3(capsys):
    from portbench import run as run_mod

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("four cards are visible")
    assert run_mod.main(["--workload", CELL, "--seed", "1", "--seconds",
                         "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""

