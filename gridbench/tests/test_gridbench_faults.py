"""On the CPU, the comparison that decides ``correct`` fails the answers
of a broken solve and of the control, and passes the reference's own.

The answers are the reference's (``control`` of each study, at float64)
on tiny grids, broken as a fault of the program would break them: the
state left unchanged (the flat start, or no solve), half of the batch
replaced by the mean of the other half, one answer altered.  The card
tests (``test_gridbench_card.py``) plant the same faults in the program
and drive whole runs."""

import numpy as np
import pytest
import torch

from _tiny import tiny_root
from gridbench.control import control_numbers
from gridbench.grid import make_grid
from gridbench.reference import compare
from gridbench.spec import load_cell

torch.set_num_threads(1)

CELLS = ["grid10k.ts_newton", "grid70k.ts_fdpf", "grid10k.n1_dc"]
CONTROL = {"grid10k.ts_newton": "bf16_product", "grid70k.ts_fdpf": "float32",
           "grid10k.n1_dc": "float32"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"))


def _answers(cell, seed, count=8):
    s = cell.settings
    arrays = make_grid(cell.config)
    stream = cell.stream(arrays, seed)
    inputs = np.concatenate([stream.payload(b) for b in (1, 2)])[:count]
    mod = cell.study_module()
    kept, tally = mod.control(arrays, s, inputs, "float64")
    return arrays, mod, kept, tally


def _unchanged(arrays, kept):
    if "flows" in kept:
        kept["flows"][:] = 0.0
    else:
        kept["vm"][:] = arrays["vm0"]
        kept["va"][:] = 0.0


def _half(arrays, kept):
    for k in ("flows", "vm", "va"):
        if k in kept:
            h = len(kept[k]) // 2
            kept[k][h:] = kept[k][:h].mean(axis=0)


def _altered(arrays, kept):
    if "flows" in kept:
        j = np.abs(kept["flows"][0]).argmax()
        kept["flows"][0, j] *= 1.001
    else:
        kept["vm"][0, np.flatnonzero(arrays["bus_type"] == 0)[3]] += 1e-3


@pytest.mark.parametrize("workload", CELLS)
def test_the_reference_passes(root, workload):
    cell = load_cell(workload, root)
    arrays, mod, kept, tally = _answers(cell, 2**31 + 17)
    ok, rows = compare.judge(mod.numbers(arrays, cell.settings, kept, tally,
                                         2**31 + 17), cell.settings["limits"])
    assert ok, rows


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_answer_is_not_correct(root, workload, fault):
    cell = load_cell(workload, root)
    arrays, mod, kept, tally = _answers(cell, 2**31 + 17)
    fault(arrays, kept)
    ok, rows = compare.judge(mod.numbers(arrays, cell.settings, kept, tally,
                                         2**31 + 17), cell.settings["limits"])
    assert not ok, rows


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_the_reference_passes(root, workload):
    cell = load_cell(workload, root)
    _, ok, rows = control_numbers(cell, 2**31 + 21, CONTROL[workload], 4)
    assert not ok, rows
    _, ok, rows = control_numbers(cell, 2**31 + 21, "float64", 4)
    assert ok, rows
    assert np.isfinite([v for _, v, _ in rows]).all()
