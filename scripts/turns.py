"""What the scripts that time trees of the port on one card share
(``ab_radix_path.py``, ``merge_variants.py``, ``pass_variants.py``).

A tree is a directory whose root holds a ``radix_sort_tpu_torch`` package:
this checkout, a parent commit unpacked with ``git archive <commit> | tar
-x -C build/parent``, or a variant that ``make_tree`` writes under
``build/variants/`` (git-ignored).  A run is a fresh process started in a
tree's root with that tree first on the path, so it imports that tree's
package and builds that tree's kernels.  The timers are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = "radix_sort_tpu_torch"


def _load_chip_smoke():
    # by its path: ROOT on sys.path would put this checkout's package ahead
    # of the tree's in a run
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_smoke = _load_chip_smoke()
time_ms = _smoke.time_ms  # one call's event time, median of 5
device_ms = _smoke.device_ms  # a call's share of 50 back-to-back calls
enqueue_us = _smoke.enqueue_us  # the host's enqueue of one call, no sync


def profiled_ms(fn) -> float:
    """Device time of one ``fn()`` by torch.profiler's kernel rows."""
    return _smoke._ms(_smoke._profile(fn, 1), 1)


def make_tree(name: str, source: str, subs, edit=None,
              scripts=()) -> Path:
    """A copy of this checkout's package under ``build/variants/<name>/``
    whose ``source`` (a path inside the package) has each ``(old, new)`` of
    ``subs`` replaced, then ``edit`` applied; ``scripts`` (names in this
    ``scripts/``) are copied into the tree's ``scripts/``."""
    tree = ROOT / "build" / "variants" / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / PACKAGE, tree / PACKAGE,
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = tree / PACKAGE / source
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {source}")
        text = text.replace(old, new)
    path.write_text(edit(text) if edit else text)
    for script in scripts:
        (tree / "scripts").mkdir(exist_ok=True)
        shutil.copy(ROOT / "scripts" / script, tree / "scripts")
    return tree


def run(tree: Path, argv) -> str:
    """The standard output of ``python argv`` run in ``tree``'s root with
    the tree first on the path.  A failed run prints the ends of its
    output and exits with its code."""
    res = subprocess.run([sys.executable, *map(str, argv)], cwd=tree,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(tree)})
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-3000:], file=sys.stderr)
        raise SystemExit(res.returncode)
    return res.stdout


def in_turns(script: str, trees: dict, order, *args) -> list:
    """``script --worker args`` run in the tree of each name of ``order``
    in turn.  Each run prints a JSON object as its last line, with its
    times under ``"times"``; the object is returned with the tree's name
    under ``"tree"``."""
    runs = []
    for name in order:
        out = run(trees[name], [os.path.abspath(script), "--worker", *args])
        runs.append({"tree": name,
                     **json.loads(out.strip().splitlines()[-1])})
        print(f"[turns] {len(runs)}: {name} ({trees[name]}) done on "
              f"{runs[-1].get('device')}", flush=True)
    return runs


def print_table(runs: list, note=lambda key: "") -> None:
    """Each measurement's times by tree in the order the runs took, then,
    where a parent and a change ran, the change's mean over the
    parent's.  ``note(key)`` is printed after the measurement's name."""
    names = list(dict.fromkeys(r["tree"] for r in runs))
    for key in runs[0]["times"]:
        by = {name: [r["times"][key] for r in runs if r["tree"] == name]
              for name in names}
        cells = "; ".join(f"{name} " + " ".join(f"{t:.4f}" for t in ts)
                          for name, ts in by.items())
        if "parent" in by and "change" in by:
            cells += (f"; change/parent "
                      f"{np.mean(by['change']) / np.mean(by['parent']):.3f}")
        print(f"{key}{note(key)}: {cells}", flush=True)
