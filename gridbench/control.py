"""The control of a cell's comparison: the reference put in the program's
place, in a lower precision, judged by the same comparison and limits.

    python3 gridbench/control.py --workload <name> --seeds <n> [<n> ...] \\
        --precision <float32|float32_solve|bf16_product|float64> \\
        [--count N] [--jobs J]

For each seed the cell's stream is drawn as a run draws it (on the card
where there is one), in the grid's bus order, and ``count`` items are
taken where a run keeps them (the seeded rows of batches 1, 2, ...).  The
study's ``control`` solves them with the reference in ``precision``, and
its ``numbers`` and the cell's limits judge the answers.  ``float64`` is
the reference itself and has to pass; a lower precision has to fail.  Each
seed's numbers and limits are printed as one JSON line.  Benchmark runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gridbench.grid import make_grid  # noqa: E402
from gridbench.reference import compare  # noqa: E402
from gridbench.spec import load_cell  # noqa: E402


def _kept_rows(K, keep, seed, count):
    """(batch, row) pairs a run keeps, from batch 1 on, ``count`` of
    them."""
    rng = np.random.default_rng([seed, 3])
    out = []
    b = 1
    while len(out) < count:
        rows = np.sort(rng.choice(K, min(keep, K), replace=False))
        out += [(b, int(r)) for r in rows]
        b += 1
    return out[:count]


def control_numbers(cell, seed, precision, count, device="cpu"):
    """(numbers, correct, rows) of the reference in ``precision`` in the
    program's place, on ``count`` of the items a run of ``cell`` with
    ``seed`` keeps."""
    s = cell.settings
    arrays = make_grid(cell.config)
    traffic = cell.stream(arrays, seed, device=device)
    kept = _kept_rows(int(s["batch"]), int(s["keep_per_batch"]), seed,
                      count)
    inputs = np.array([traffic.payload(b)[r] for b, r in kept])
    mod = cell.study_module()
    out, tally = mod.control(arrays, s, inputs, precision)
    numbers = mod.numbers(arrays, s, out, tally, seed)
    ok, rows = compare.judge(numbers, s["limits"])
    return numbers, ok, rows


def _one(args):
    workload, seed, precision, count, device, root = args
    cell = load_cell(workload, root)
    numbers, ok, rows = control_numbers(cell, seed, precision, count,
                                        device)
    return dict(workload=workload, seed=seed, precision=precision,
                count=count, correct=ok,
                checks={k: {"value": v, "limit": lim}
                        for k, v, lim in rows})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", required=True,
                    choices=("float64", "float32", "float32_solve",
                             "bf16_product"))
    ap.add_argument("--count", type=int, default=8)
    ap.add_argument("--jobs", type=int, default=1)
    args = ap.parse_args(argv)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    jobs = [(args.workload, s, args.precision, args.count, device, ROOT)
            for s in args.seeds]
    if args.jobs > 1:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(args.jobs,
                                 mp_context=mp.get_context("spawn")) as ex:
            results = list(ex.map(_one, jobs))
    else:
        results = [_one(j) for j in jobs]
    for r in results:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
