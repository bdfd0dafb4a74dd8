"""The radix pass kernel's instances as ptxas and the SASS see them.

    python3 scripts/pass_kernel_instances.py [--parent DIR]

Compiles ``csrc/radix.cu`` (``rank_scatter_kernel``: int32 planes and a
narrow key plane) and ``csrc/radix_wide.cu`` (``rank_scatter_wide_kernel``:
some plane of 8 bytes) as ``_build.py`` does, all at once, and prints
ptxas's registers, spills and shared memory for every pass kernel instance.
With ``--parent`` (a tree unpacked by ``git archive <commit> | tar -x -C
DIR``) the parent's ``radix.cu`` is compiled beside them: each line shows
the parent's figures too, and each of the parent's instances is said to
have its SASS, instruction for instruction, or to differ.  Needs ``nvcc``,
``cu++filt`` and ``cuobjdump`` (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = Path("radix_sort_tpu_torch") / "csrc"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")


def _tool(name: str) -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return nvcc if name == "nvcc" else (
        shutil.which(name) or str(Path(nvcc).parent / name))


def _demangle(names) -> dict:
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                         capture_output=True, text=True).stdout.splitlines()
    return dict(zip(names, out))


def _instance(name: str) -> str:
    """A pass kernel instance by its name and template arguments, as
    cu++filt writes them: "rank_scatter_kernel<(int)256, (int)32, (bool)1,
    unsigned int, (int)4>"."""
    return name.split("::", 1)[-1].split(">(", 1)[0] + ">"


def _compile(source: Path, out: Path) -> subprocess.Popen:
    """nvcc -cubin -Xptxas -v of one source, started."""
    return subprocess.Popen(
        [_tool("nvcc"), *FLAGS, "-Xptxas", "-v", "-cubin", str(source),
         "-o", str(out)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _ptxas_lines(log: str) -> dict:
    """rank_scatter_kernel instance -> ptxas's registers, spills and shared
    memory line."""
    lines = log.splitlines()
    entry = r"Compiling entry function '(\w+)'"
    names = _demangle([m.group(1) for line in lines
                       for m in [re.search(entry, line)] if m])
    found, mangled = {}, None
    for line in lines:
        m = re.search(entry, line)
        if m:
            mangled = m.group(1)
            continue
        name = names.get(mangled, "")
        if "rank_scatter_" in name and ("registers" in line
                                        or "spill" in line):
            key = _instance(name)
            found[key] = (found.get(key, "") + " "
                          + line.split(":", 1)[-1].strip()).strip()
    return found


def _sass(cubin: Path) -> dict:
    """rank_scatter_kernel instance -> its SASS, instruction lines only."""
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    bodies, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            bodies[cur] = []
        elif cur and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            bodies[cur].append(line.split("*/", 1)[-1].split("/*", 1)[0]
                               .strip())
    names = _demangle(list(bodies))
    return {_instance(names[k]): v for k, v in bodies.items()
            if "rank_scatter_" in names[k]}


def compare_instances(parent: Path | None) -> None:
    """This tree's radix.cu and radix_wide.cu and the parent's radix.cu
    compiled at once, then each instance's ptxas line and, against the
    parent, whether its SASS is the parent's."""
    units = [ROOT / CSRC / "radix.cu", ROOT / CSRC / "radix_wide.cu"] + (
        [parent / CSRC / "radix.cu"] if parent else [])
    with tempfile.TemporaryDirectory() as tmp:
        cubins = [Path(tmp) / f"radix{i}.cubin" for i in range(len(units))]
        procs = [_compile(u, c) for u, c in zip(units, cubins)]
        logs = []
        for p in procs:
            out, err = p.communicate()
            if p.returncode:
                raise SystemExit(f"nvcc failed:\n{out}{err}")
            logs.append(err)
        ptx = [_ptxas_lines(log) for log in logs]
        code = [_sass(c) for c in cubins]
    here = {**ptx[0], **ptx[1]}
    there = ptx[2] if parent else {}
    code = [{**code[0], **code[1]}] + code[2:]
    for key in sorted(here):
        line = f"[ptxas] <{key}>: {here[key]}"
        if key in there:
            line += f" | parent: {there[key]}"
        print(line, flush=True)
    if parent:
        for key in sorted(code[1]):
            mine = code[0].get(key, [])
            same = mine == code[1][key]
            print(f"[sass] <{key}>: {'the parent' if same else 'differs'}"
                  f" ({len(mine)} against {len(code[1][key])} "
                  f"instructions)", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    compare_instances(ap.parse_args().parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
