"""Measure design alternatives of the onesweep pass kernel against the
kernel as it is, on one card.

    python3 scripts/pass_variants.py [--rounds 2]

Each variant is a copy of ``radix_sort_tpu_torch`` under
``build/variants/<name>/`` (git-ignored) whose ``csrc/radix.cu`` differs
from this tree's by one textual substitution:

  acquire     status words stored with st.release and loaded with
              ld.acquire at device scope, in place of relaxed;
  match_any   the lanes of a digit found with __match_any_sync, in place
              of the atomicOr lane masks;
  no_uniform  no warp-uniform fast path: every round goes through the
              lane masks.

``scripts/onesweep_probe.py`` runs in each tree, the trees in turns
(``--rounds`` times), each in a fresh process that builds its own kernels;
its rows are printed under the tree's name.  Needs one card.
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "build" / "variants"

VARIANTS = {
    "acquire": [("ld.relaxed.gpu.global", "ld.acquire.gpu.global"),
                ("st.relaxed.gpu.global", "st.release.gpu.global")],
    "match_any": [("""    if (uniform) {
      peers = __ballot_sync(0xFFFFFFFFu, valid);
    } else {
      if (valid) atomicOr(m, 1u << lane);
      __syncwarp();
      peers = valid ? *m : 0u;
    }""", """    peers = __match_any_sync(0xFFFFFFFFu, valid ? d : 0xFFFFFFFFu);"""),
                  ("      if (!uniform) *m = 0u;\n", "")],
    "no_uniform": [("const bool uniform = __all_sync(0xFFFFFFFFu, "
                    "!valid || d == d0);",
                    "const bool uniform = false && d0 == 0u;")],
}


def make_tree(name: str, subs) -> Path:
    tree = OUT / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(ROOT / "radix_sort_tpu_torch",
                    tree / "radix_sort_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tree / "scripts").mkdir(parents=True)
    shutil.copy(ROOT / "scripts" / "onesweep_probe.py", tree / "scripts")
    src = tree / "radix_sort_tpu_torch" / "csrc" / "radix.cu"
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in radix.cu")
        text = text.replace(old, new)
    src.write_text(text)
    return tree


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    trees = {"as_is": ROOT}
    trees.update({name: make_tree(name, subs)
                  for name, subs in VARIANTS.items()})
    for _ in range(args.rounds):
        for name, tree in trees.items():
            res = subprocess.run(
                [sys.executable, str(tree / "scripts" / "onesweep_probe.py")],
                capture_output=True, text=True)
            print(f"== {name}", flush=True)
            if res.returncode != 0:
                print(res.stdout[-2000:], res.stderr[-2000:], flush=True)
                return res.returncode
            print("\n".join(line for line in res.stdout.splitlines()
                            if "ms" in line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
