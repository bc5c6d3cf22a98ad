"""On the card (marker ``gpu``): whole runs of the tiny cells through the
CUDA kernels, their traced slices reading what the program counted, the
dummy cell of new files, and runs with a fault planted under the timed
path (``_faults.plant``), which have to come out not correct.  The look
for a card is the command line's (``run.py``), skipped here.

    python -m pytest -m gpu gridbench/tests
"""

import pytest
import torch

from _faults import FAULTS, plant
from _tiny import dummy_root, tiny_root
from gridbench.harness import run_cell
from gridbench.spec import load_cell

CELLS = ["grid10k.ts_newton", "grid70k.ts_fdpf", "grid10k.n1_dc"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"), n_bus=2000, batch=8)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_on_the_card(card, root, workload):
    cell = load_cell(workload, root)
    r = run_cell(cell, 2**31 + 3, 0.5, False, card, 0.0)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["device"]["platform"] == "gpu"
    assert list(r)[-1] == "checks"
    r = run_cell(cell, 2**31 + 4, 0.0, True, card, 0.0)
    assert r["correct"], r["checks"]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert set(r["metrics"]) == {m["name"] for m in cell.per_layer}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_under_the_timed_path_is_not_correct(card, root, workload,
                                                     fault):
    cell = load_cell(workload, root)
    cell.settings["study"] = plant(root, cell.settings["study"], fault)
    r = run_cell(cell, 2**31 + 17, 0.0, False, card, 0.0)
    assert not r["correct"], r["checks"]


@pytest.mark.gpu
def test_a_dummy_cell_of_new_files_runs(card, tmp_path):
    cell = load_cell("dummy.wave", dummy_root(tmp_path))
    r = run_cell(cell, 12345, 0.0, True, card, 0.0)
    assert r["correct"], r["checks"]
    assert r["metrics"]["dummy_count"]["value"] == r["attempted"] + 0.5
    r = run_cell(cell, 12345, 0.0, False, card, 0.0)
    assert set(r["metrics"]) == {"setup_s", "pf_snapshots_per_s"}
