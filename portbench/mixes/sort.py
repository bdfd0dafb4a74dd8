"""Sorts through the program's entry points.

Traffic parameters: ``n`` keys a call, their ``distribution`` (a name of
``gen/keys.py``), ``payload`` (a dtype name for a row-id payload 0..n-1,
or null for a key-only sort) and the program's ``engine``.  The key dtype
is the configuration's ``key_dtype``.  Every call sorts the same inputs,
made once on the card from the seed: ``radix_sort_tpu_torch.sort_kv``
with a payload, ``sort`` without.  The call's answer is its output
tensors; the harness's synchronise after it ends the call."""

from __future__ import annotations

import torch

import radix_sort_tpu_torch as rt
from portbench.gen import keys as keygen


def rows_per_call(cell) -> int:
    return cell.traffic["n"]


def make_inputs(cell, seed, device) -> dict:
    t = cell.traffic
    inputs = {"keys": keygen.generate(t["distribution"],
                                      cell.config["key_dtype"], t["n"], seed,
                                      device)}
    if t["payload"]:
        inputs["values"] = torch.arange(t["n"], device=device).to(
            keygen.torch_dtype(t["payload"]))
    return inputs


def prepare(cell, inputs, device):
    return inputs


def call(cell, state):
    engine = cell.traffic["engine"]
    if "values" in state:
        return rt.sort_kv(state["keys"], state["values"], engine=engine)
    return rt.sort(state["keys"], engine=engine), None


def finish(cell, state, raw) -> dict:
    keys, values = raw
    return {"keys": keys} if values is None else {"keys": keys,
                                                  "values": values}


def counters() -> dict:
    return {}
