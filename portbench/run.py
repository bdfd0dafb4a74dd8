"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` (and with ``--trace 1`` ``breakdown``), a few more facts, and
last ``checks``: every number compared with the plain reference beside
its limit, which are also the last lines of standard error.

A cell of one card runs in this process.  A cell of four
(``"chips": 4``) runs one process a card (``portbench/launch.py``): this
process builds the kernel library, spawns the ranks with ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` set, and
prints rank 0's result line once every rank has ended with code 0;
set-up counts from this process's start, the ranks' start and NCCL's
set-up included.

Exit codes: 0 with a result; 3 where no CUDA card, or fewer than the
cell needs, is visible; 4 where a JAX module or the JAX package was
loaded (in this process or a rank); any other failure, of this process
or of a rank, raises (1) or ends the run with that rank's code, every
other rank killed and no result printed; 124 where the ranks did not end
within the launcher's limit.  ``--program control`` puts the reference's
control in the program's place.
"""

import time

T_START = time.time()  # set-up counts from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's kernel library is already in ``build/kernels``)."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--program", choices=("port", "control"), default="port")
    return ap.parse_args(argv)


def power_limit_w(index: int = 0):
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(index)],
            capture_output=True, text=True, check=True, timeout=30).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    from portbench import result, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible: no result", file=sys.stderr)
        return 3
    from radix_sort_tpu_torch import _build

    t = time.time()
    _build.build()  # the program's kernel library, once a checkout
    build_s = time.time() - t
    extra = {"seed": args.seed, "program": args.program, "build_s": build_s}
    if cell.chips == 1:
        from portbench import core

        res = core.drive(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START, args.program)
        line = result.assemble(
            cell, res, res.ready_s, bool(args.trace), "gpu",
            {**extra, "window_s": res.window_s,
             "power_limit_w": power_limit_w()})
    else:
        from portbench import launch

        rc, line = launch.launch(
            cell, {"seed": args.seed, "seconds": args.seconds,
                   "trace": bool(args.trace), "program": args.program},
            T_START, {**extra, "power_limit_w": power_limit_w()})
        if rc != 0:
            return rc
    bad = result.forbidden_modules()
    if bad:
        print(f"loaded, and must not be: {', '.join(bad)}: no result",
              file=sys.stderr)
        return 4
    for text in result.check_lines(line):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
