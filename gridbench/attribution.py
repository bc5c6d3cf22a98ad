"""One cell's set-up and traced slice, set against the program's spans.

    python3 gridbench/attribution.py --workload <name> --seed <n> \\
        [--cost 0] [--out <file.json>]

from the root of a checkout, on the card, as ``run.py`` runs a cell.  A
recorder of the program's spans (``csparse3_tpu_torch.utils.profiling``)
is open from before the study is built, so the set-up's spans are kept;
the traced slice (the cell's ``trace_batches`` batches, as ``run.py
--trace 1`` profiles them) runs under ``spans.profile_linked`` with a
``bench.batch`` span of the benchmark's own around each batch.  Standard
error shows the slice's whole ``spans.attribute`` table, and the result
holds the 12 span names of most self time (``by_span``), the
per-layer metrics of the spans, the K1 / K4 records issued inside
``spmv`` spans against the program's launch counters, and the device
records with no runtime record.  ``--cost N`` times N batches with the
recorder open and N with none, in turns, without the profiler: what the
program's spans cost the host.  The last line of standard output is the
result as one JSON object, also written to ``--out``.
"""

import time

T0 = time.time()

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from collections import Counter  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the metrics of the spans, by name: (kind, span names)
METRICS = {
    "front_lu_self.ts": ("self", ("front.factor", "front.solve")),
    "front_lu_self.n1": ("self", ("front.factor", "front.retarget")),
    "level_solve_self.n1": ("self", ("trisolve",)),
    "banded_self.ts": ("self", ("banded.sweeps",)),
    "idle_dispatch": ("idle", None),
    "idle_upload": ("idle", ("io.upload",)),
    "setup_factor_s": ("setup", ("setup.symbolic", "setup.banded_factor")),
}


def _slice(cell, drv, study, log):
    """One traced slice's result."""
    from csparse3_tpu_torch.utils import profiling
    from gridbench import spans as sp
    from gridbench import trace as tr

    nb = int(cell.settings["trace_batches"])
    counted0 = study.counters()
    with profiling.Timer() as rec:
        def run():
            n = 0
            for b in range(1, 1 + nb):
                with rec.span("bench.batch", b=b):
                    n += drv.batch(b)
            return n

        n_items, records, links, wall, window, base = sp.profile_linked(run)
    counted = {k: v - counted0.get(k, 0) for k, v in study.counters().items()}
    spans = sp.in_frame(rec.spans, base)
    table = sp.attribute(spans, records, links, window)
    log(f"slice {wall:.3f} s, {n_items} items, {len(records)} device "
        f"records, {len(spans)} spans\n{sp.table_text(table)}")
    who = sp.owners(spans, links)
    spmv = {k: sum(1 for (name, _, _), w in zip(records, who)
                   if k in name and w == "spmv") for k in counted}
    unlinked = Counter(name[:96] for (name, _, _), w in zip(records, who)
                       if w == sp.UNLINKED)
    summ = tr.summarize(records, wall, counted)
    metrics = {}
    for name, (kind, names) in METRICS.items():
        if kind == "self":
            metrics[name] = sp.self_share(spans, names, wall)
        elif kind == "idle":
            metrics[name] = sp.idle_share(table, names)
    return dict(
        wall_s=wall, items=n_items, records=len(records),
        idle_pct=100.0 * (1.0 - summ["busy_s"] / wall),
        launches_per_item=summ["launches"] / n_items,
        by_span=sp.by_span(table), metrics=metrics,
        counted=counted, spmv_records=spmv,
        unlinked=dict(unlinked),
        unlinked_pct=100.0 * sum(unlinked.values()) / max(len(records), 1))


def _cost(drv, n, start):
    """Seconds of ``n`` batches with a recorder open and ``n`` with none,
    in turns, beginning with batch ``start``."""
    from csparse3_tpu_torch.utils import profiling

    on, off, b = [], [], start
    for _ in range(n):
        for side in (on, off):
            if side is on:
                with profiling.Timer():
                    drv.batch(b, record=False)
            else:
                drv.batch(b, record=False)
            side.append(drv.seconds[-1])
            b += 1
    return {"on_s": on, "off_s": off}


def attribute_cell(cell, seed, device, cost=0, t0=None, log=None):
    """The result of ``main`` for ``cell`` on ``device``."""
    import numpy as np
    import torch

    from csparse3_tpu_torch.utils import profiling
    from gridbench import grid as gridmod
    from gridbench import spans as sp
    from gridbench.harness import _Driver

    log = log or (lambda line: None)
    t0 = time.time() if t0 is None else t0
    s = cell.settings
    with profiling.Timer() as rec:
        arrays = gridmod.make_grid(cell.config)
        study = cell.study_module().Study(arrays, s, device)
        traffic = cell.stream(arrays, seed, order=study.order, device=device)
        drv = _Driver(study, traffic, s, seed)
        drv.batch(0, record=False)
    setup_wall = time.time() - t0
    setup = {}
    for span in rec.spans:
        if span.name.startswith("setup.") and span.end_ns:
            setup.setdefault(span.name, []).append(
                dict(span.counts, s=span.seconds))
    log("set-up: " + json.dumps(setup))
    out = dict(workload=cell.name, seed=seed,
               kind=torch.cuda.get_device_name(device),
               setup_s=setup_wall, setup=setup,
               setup_factor_s=sum(x["s"] for n in METRICS["setup_factor_s"][1]
                                  for x in setup.get(n, [])),
               warm_batch_s=drv.seconds[0],
               warm_by_span={k: v for k, v in sp.self_seconds(
                   sp.in_frame(rec.spans)).items()
                   if not k.startswith("setup.")},
               slice=_slice(cell, drv, study, log))
    if cost:
        out["cost"] = _cost(drv, cost, 1 + int(s["trace_batches"]))
        c = out["cost"]
        log(f"cost: median on {np.median(c['on_s']):.4f} s off "
            f"{np.median(c['off_s']):.4f} s")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gridbench.spec import load_cell

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        sys.exit("gridbench: no CUDA device")
    cell = load_cell(args.workload, ROOT)
    res = attribute_cell(cell, args.seed, torch.device("cuda", 0),
                         args.cost, T0,
                         log=lambda line: print(f"gridbench: {line}",
                                                file=sys.stderr, flush=True))
    line = json.dumps(res)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
