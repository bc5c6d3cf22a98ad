"""On the card (marker ``gpu``): the program's spans share the clock of the
profiler's runtime records, and in the traced slices of the tiny cells
the K1 / K4 records issued inside ``spmv`` spans are the launches the
program counted, and almost every device record has its runtime record.

    python -m pytest -m gpu gridbench/tests
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT, tiny_root
from gridbench.attribution import attribute_cell
from gridbench.spec import load_cell

CELLS = ["grid10k.ts_newton", "grid70k.ts_fdpf", "grid10k.n1_dc"]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


CLOCK = """
import json, sys
import torch
from csparse3_tpu_torch.utils import profiling
from csparse3_tpu_torch.utils.roofline import triad_cuda
from gridbench import spans as sp

a = torch.ones(1 << 20, device="cuda")
s = torch.full((1,), 2.0, device="cuda")
triad_cuda(a, s)                      # build and load the kernel
torch.cuda.synchronize()


def one():
    with profiling.span("triad"):
        triad_cuda(a, s)


with profiling.Timer() as rec:
    _, records, links, _, window, base = sp.profile_linked(one)
json.dump(dict(records=records, links=links, window=window,
               spans=sp.in_frame(rec.spans, base)), sys.stdout)
"""


@pytest.mark.gpu
def test_a_span_holds_its_launchs_runtime_record(card):
    """In a process of its own: run after the other tests' profiles in
    one process, with the triad's library loaded only then, the profile
    held no device record at all (H100, torch 2.11)."""
    out = subprocess.run([sys.executable, "-c", CLOCK], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads(out.stdout)
    records, links, window = got["records"], got["links"], got["window"]
    mine = [i for i, r in enumerate(records) if "triad" in r[0]]
    assert len(mine) == 1, records
    (name, start, end, _), = got["spans"]
    k = mine[0]
    assert links[k] is not None
    assert start <= links[k] <= end
    assert records[k][1] >= start
    assert window[0] <= start <= end <= window[1]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("tiny"), n_bus=2000, batch=8)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_spmv_spans_hold_the_counted_launches(card, root, workload):
    r = attribute_cell(load_cell(workload, root), 2**31 + 5, card)
    sl = r["slice"]
    assert sl["spmv_records"] == sl["counted"]
    assert all(v > 0 for v in sl["counted"].values())
    assert sl["unlinked_pct"] < 1.0, sl["unlinked"]
    names = {row[0] for row in sl["by_span"]}
    assert {"study.batch", "bench.batch"} <= names
    assert r["setup"] and r["setup_factor_s"] > 0
