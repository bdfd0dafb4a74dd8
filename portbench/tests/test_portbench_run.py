"""Whole runs on the CPU at small sizes: the harness without its look
for a card, driving the program's CPU path.  A sound program comes out
``correct``; the same run with the timed path broken underneath (a call
that hands back its input unchanged, half of the rows left out, an answer
altered where it is made) and the control in the program's place come
out not correct.  The last line has the contract's keys."""

import json
import time

import pytest
import torch

import radix_sort_tpu_torch as rt
from portbench import core, result

SIZES = {"kvsort-u32-2p27": {"n": 1 << 12},
         "q1-sf10": {"lineitem_rows": 20_000}}
# the sort mix's key-only traffic (``payload`` null), which no cell of
# BENCHMARK.json sends yet
KEY_ONLY = {"n": 1 << 11, "payload": None}


def run(cell, trace=False, program="port", seconds=0.3, seed=2**31 + 9):
    res = core.drive(cell, seed, seconds, trace, "cpu", time.time(), program)
    return result.assemble(cell, res, res.ready_s, trace, "cpu",
                           {"seed": seed})


@pytest.mark.parametrize("name,sizes", [
    *sorted(SIZES.items()), ("kvsort-u32-2p27", KEY_ONLY)])
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_has_the_contract_keys(small_cell, name,
                                                        sizes, trace):
    cell = small_cell(name, **sizes)
    line = run(cell, trace)
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"] and keys[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    wanted = cell.per_layer if trace else cell.end_to_end
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["device_ops"]) <= 10
    got = line["metrics"]
    assert set(got) <= {m["name"] for m in wanted}
    assert all(set(v) == {"value", "unit"} for v in got.values())
    if not trace:  # every end-to-end metric is read on every run
        assert set(got) == {m["name"] for m in wanted}
    assert set(line["checks"]) == set(cell.reference.LIMITS)
    json.dumps(line)
    assert all(t.startswith("check ") for t in result.check_lines(line))


def _sort_fault(kind):
    real = rt.sort_kv

    def sort_kv(keys, values, **kw):
        if kind == "unchanged":
            return keys, values
        k, v = real(keys, values, **kw)
        if kind == "half":  # the second half of the rows left unsorted
            h = keys.shape[0] // 2
            k1, v1 = real(keys[:h], values[:h], **kw)
            return torch.cat([k1, keys[h:]]), torch.cat([v1, values[h:]])
        v = v.clone()
        v[v.shape[0] // 3] += 1  # one payload altered where it is made
        return k, v

    return sort_kv


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_sort_is_not_correct(small_cell, monkeypatch, kind):
    monkeypatch.setattr(rt, "sort_kv", _sort_fault(kind))
    line = run(small_cell("kvsort-u32-2p27", **SIZES["kvsort-u32-2p27"]))
    assert not line["correct"] and line["failed"] > 0


@pytest.mark.parametrize("kind", ["unchanged", "altered"])
def test_broken_key_sort_is_not_correct(small_cell, monkeypatch, kind):
    real = rt.sort

    def sort(keys, **kw):
        if kind == "unchanged":
            return keys
        out = real(keys, **kw).clone()
        out.view(torch.int32)[7] ^= 1
        return out

    monkeypatch.setattr(rt, "sort", sort)
    line = run(small_cell("kvsort-u32-2p27", **KEY_ONLY))
    assert not line["correct"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_broken_query_is_not_correct(small_cell, monkeypatch, kind):
    real = rt.Query.collect

    def collect(self):
        if kind == "unchanged":
            return self._table
        if kind == "half":  # the query over half of the rows
            t = self._table
            self._table = rt.Table(t.columns, num_rows=t.capacity // 2)
            return real(self)
        out = real(self)
        out.columns["sum_charge"] = out.columns["sum_charge"].clone()
        out.columns["sum_charge"][0] += 1
        return out

    monkeypatch.setattr(rt.Query, "collect", collect)
    line = run(small_cell("q1-sf10", **SIZES["q1-sf10"]))
    assert not line["correct"] and line["failed"] == line["attempted"]


@pytest.mark.parametrize("name,sizes", [
    ("kvsort-u32-2p27", {"n": 1 << 16}),
    ("kvsort-u32-2p27", {"n": 1 << 16, "payload": None}),
    ("q1-sf10", {"lineitem_rows": 1 << 20})])
def test_control_in_the_programs_place_is_not_correct(small_cell, name,
                                                      sizes):
    line = run(small_cell(name, **sizes), program="control", seconds=0.1)
    assert not line["correct"]
    limits = small_cell(name).reference.LIMITS
    assert any(v["value"] > limits[k] for k, v in line["checks"].items())
