"""Runs of every cell on the card, short windows at the cells' own sizes
(``python -m pytest portbench/tests -m cuda``): the program is correct
and its control is not; the program's peak leaves out the answer the
harness keeps.  They skip where no card is visible."""

import pytest
import torch

from portbench import spec

CELLS = [w["name"] for w in spec.load()["workloads"]]


def _cards(cell):
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{cell.name} needs {cell.chips} CUDA card(s)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("program", ["port", "control"])
def test_cell_on_the_card(name, program, capsys):
    import json

    from portbench import run

    _cards(spec.cell(name))
    rc = run.main(["--workload", name, "--seed", "2147483999", "--seconds",
                   "2", "--trace", "0", "--program", program])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] == (program == "port"), line["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_peak_leaves_out_the_kept_answer(small_cell, trace):
    import time

    from portbench import core

    cell = small_cell("kvsort-u32-2p27", n=1 << 22)
    _cards(cell)
    res = core.drive(cell, 2147483998, 1.0, trace, "cuda", time.time())
    # the program's peak: the inputs, one call's answer and the sort's
    # scratch, 32 MiB each; the answer kept for the check would add 32 more
    mib = 2**20
    assert res.calls > 3 and res.wrong == 0
    assert 96 * mib <= res.peak_bytes < 112 * mib, res.peak_bytes / mib
