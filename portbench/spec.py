"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file
``configs[].file`` gives, and a traffic mix, whose parameters are
``traffic/<traffic>.json``.  The traffic file's ``mix`` names the module
that drives the program, ``mixes/<mix>.py``, and its plain reference,
``reference/<mix>.py``.  A per-layer metric is read by
``metrics/<name>.py``.  Modules are loaded from their files, so a name
with a dot in it still finds its file."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"


def load(path: Path = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in file ``path``, imported once under ``name``."""
    if name in sys.modules:
        return sys.modules[name]
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod
    mod_spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def mix(self):
        mix = self.traffic["mix"]
        return load_module(HERE / "mixes" / f"{mix}.py",
                           f"portbench_mix_{mix}")

    @property
    def reference(self):
        mix = self.traffic["mix"]
        return load_module(HERE / "reference" / f"{mix}.py",
                           f"portbench_reference_{mix}")

    def reader(self, metric: str):
        return load_module(HERE / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric}")


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json`` by default)."""
    bench = load() if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name, w["chips"], w["config"], config, w["traffic"],
                traffic, e2e, per_layer)
