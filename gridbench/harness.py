"""One run of one cell: set-up, the measured window or the traced slice,
then the comparison with the reference.

Set-up builds the grid from its configuration, the program's study (host
factorizations and plans, its kernels loaded from the program's build
directory inside the checkout), the traffic pool, and runs one warm batch
at the cell's own batch size.  ``setup_s`` runs from process start to the
end of that batch.

The window (``trace=False``) is a closed loop: the next batch goes to the
program once the previous batch's results are on the host, until
``seconds`` have passed; the rate is all the items over all the time.
A traced run (``trace=True``) instead runs the cell's fixed slice of
batches under ``torch.profiler`` and reports the per-layer metrics.

Of every batch a seeded few result rows are kept; once the window has
closed, the device peak is read and the program's state is freed, the
study's ``numbers`` set them against the reference and
``reference.compare.judge`` holds each number to its limit.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from . import grid as gridmod
from . import trace as tracemod
from .reference import compare
from .spec import Cell


class _Driver:
    """Feeds batches to the study and keeps what the check needs."""

    def __init__(self, study, traffic, settings, seed):
        self.study, self.traffic = study, traffic
        self.keep_n = int(settings["keep_per_batch"])
        self.rng = np.random.default_rng([seed, 3])
        self.kept, self.tallies, self.items = [], [], []
        self.seconds = []

    def batch(self, b: int, record=True):
        items = self.traffic.items(b)
        payload = self.traffic.payload(b)
        t = time.perf_counter()
        out = self.study.run(payload)
        self.seconds.append(time.perf_counter() - t)
        if record:
            K = len(items)
            rows = np.sort(self.rng.choice(K, min(self.keep_n, K),
                                           replace=False))
            rec = self.study.keep(out, rows, payload)
            rec["item"] = items[rows]
            self.kept.append(rec)
            self.tallies.append(self.study.tally(out))
            self.items.append(items)
        return len(items)

    def joined(self):
        kept = {k: np.concatenate([r[k] for r in self.kept])
                for k in self.kept[0]}
        tally = {k: np.concatenate([t[k] for t in self.tallies])
                 for k in self.tallies[0]}
        tally["item"] = np.concatenate(self.items)
        return kept, tally


def _device_info(device, chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w()}


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float, log=None) -> dict:
    """One run of ``cell`` on the card ``device``; returns the result
    line's object, its ``checks`` last.  ``t0``: the process start
    (``time.time()``).  ``log``: called with a line of text for each phase
    (its seconds, the batches' seconds and iterations)."""
    log = log or (lambda line: None)
    s = cell.settings
    arrays = gridmod.make_grid(cell.config)
    study_mod = cell.study_module()
    study = study_mod.Study(arrays, s, device)
    traffic = cell.stream(arrays, seed, order=study.order, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    drv = _Driver(study, traffic, s, seed)
    drv.batch(0, record=False)          # warm: the cell's own batch size
    t_start = time.perf_counter()
    setup_s = time.time() - t0
    log(f"setup_s {setup_s:.3f} warm batch {drv.seconds[0]:.3f} s")

    summary = None
    if trace:
        counted0 = study.counters()

        def slice_():
            return sum(drv.batch(b) for b in
                       range(1, 1 + int(s["trace_batches"])))

        n_items, records, window_s = tracemod.profile_device(slice_)
        counted = {k: v - counted0.get(k, 0)
                   for k, v in study.counters().items()}
        summary = tracemod.summarize(records, window_s, counted)
    else:
        # each batch ends with its results on the host: the window closes
        # on the last one's copy
        n_items, b = 0, 1
        while True:
            n_items += drv.batch(b)
            b += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start

    t_check = time.perf_counter()
    dev_info = _device_info(device, cell.chips)
    bs = np.array(drv.seconds[1:])
    log(f"window {window_s:.3f} s, {len(bs)} batches, batch s min "
        f"{bs.min():.4f} median {np.median(bs):.4f} max {bs.max():.4f}; "
        f"first {np.round(bs[:4], 4).tolist()}")
    kept, tally = drv.joined()
    if "it" in tally:
        its = tally["it"].reshape(len(bs), -1).max(axis=1)
        v, c = np.unique(its, return_counts=True)
        log(f"batches by their most iterations "
            f"{dict(zip(v.tolist(), c.tolist()))}, "
            f"mean per item {tally['it'].mean():.4f}")
    item = study.item
    del drv, study
    gc.collect()
    torch.cuda.empty_cache()
    numbers = study_mod.numbers(arrays, s, kept, tally, seed)
    correct, rows = compare.judge(numbers, s["limits"])
    log(f"check {time.perf_counter() - t_check:.3f} s, "
        f"{len(kept['item'])} kept")

    ctx = dict(settings=s, item=item, items=n_items, batch=int(s["batch"]),
               iterations=tally.get("it"), trace=summary, arrays=arrays,
               kind=dev_info["kind"], setup_s=setup_s, window_s=window_s)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.metric_reader(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": int(n_items),
              "failed": int(numbers["failed"]), "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary["busy_s"]
        dev_info["window_s"] = summary["window_s"]
        result["breakdown"] = tracemod.breakdown(summary)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result
