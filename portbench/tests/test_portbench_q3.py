"""The q3-sf10 cell as whole runs on the CPU at a small scale factor: a
sound program comes out ``correct`` with the cell's metrics (the join's
span and counter among the traced ones); a join that loses a matched row
(and counts it), or raises its overflow flag, and the float32 control do
not."""

import time

import pytest

import radix_sort_tpu_torch as rt
from portbench import core, result
from radix_sort_tpu_torch.ops import join as join_ops

SMALL = {"scale_factor": 0.001, "customer_rows": 150, "orders_rows": 1500,
         "lineitem_rows": 5999}


def run(cell, trace=False, program="port", seed=2**31 + 17):
    res = core.drive(cell, seed, 0.2, trace, "cpu", time.time(), program)
    return result.assemble(cell, res, res.ready_s, trace, "cpu",
                           {"seed": seed})


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(small_cell, trace):
    cell = small_cell("q3-sf10", **SMALL)
    line = run(cell, trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    wanted = {m["name"] for m in (cell.per_layer if trace
                                  else cell.end_to_end)}
    assert set(line["metrics"]) == wanted
    if trace:
        rows = SMALL["orders_rows"] + SMALL["customer_rows"] + \
            SMALL["lineitem_rows"] + SMALL["orders_rows"]
        assert line["metrics"]["join_sorted_rows"]["value"] == rows


@pytest.mark.parametrize("fault", ["row_lost", "overflow"])
def test_broken_join_is_not_correct(small_cell, monkeypatch, fault):
    real = join_ops.hash_join

    def hash_join(probe, build, key, **kw):
        t, stats = real(probe, build, key, **kw)
        if fault == "overflow":
            return t, {**stats, "overflow": stats["overflow"] | True}
        return (rt.Table(t.columns, num_rows=t.num_rows - 1),
                {**stats, "match_count": stats["match_count"] - 1})

    monkeypatch.setattr(join_ops, "hash_join", hash_join)
    line = run(small_cell("q3-sf10", **SMALL))
    assert not line["correct"] and line["failed"] == line["attempted"]


def test_control_in_the_programs_place_is_not_correct(small_cell):
    line = run(small_cell("q3-sf10", **SMALL), program="control")
    assert not line["correct"]
    assert line["checks"]["revenue_wrong"]["value"] > 0
