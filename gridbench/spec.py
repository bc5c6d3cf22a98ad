"""Where the benchmark finds what ``BENCHMARK.json`` names.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by its name:

* a configuration: the ``file`` its entry in ``BENCHMARK.json`` gives;
* a traffic mix: ``gridbench/traffic/<name>.json``, whose ``kind``
  names its stream, ``gridbench/streams/<kind>.py``, a module with
  ``Stream``;
* a cell's study settings and limits: ``gridbench/cells/<workload>.json``;
* a metric's reader: ``gridbench/metrics/<metric>.py``, a module with
  ``read(ctx)`` that returns a number or None;
* a study: ``gridbench/studies/<study>.py``, a module with ``Study`` (the
  program's side), ``numbers`` (the check of its answers against the
  reference) and ``control`` (the reference in the program's place).

Each lookup tries the directory of the ``BENCHMARK.json`` in use first and
this package's own directory second, so a file added beside another
``BENCHMARK.json`` (a later cell, or a test's temporary directory) is found
without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

#: this package's directory
HERE = os.path.dirname(os.path.abspath(__file__))
#: the checkout that holds this package and ``BENCHMARK.json``
ROOT = os.path.dirname(HERE)
#: the package's folder name under a checkout
PKG = os.path.basename(HERE)


def _find(root: str, *parts: str) -> str:
    for base in (os.path.join(root, PKG), HERE):
        path = os.path.join(base, *parts)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"no {os.path.join(PKG, *parts)} under {root} or {ROOT}")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{PKG}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def study_module(study: str, root: str = ROOT):
    """The module of the study ``study``."""
    return _module(_find(root, "studies", f"{study}.py"), study)


def stream_module(kind: str, root: str = ROOT):
    """The module of the traffic kind ``kind``."""
    return _module(_find(root, "streams", f"{kind}.py"), kind)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    settings: dict
    end_to_end: list
    per_layer: list
    root: str

    def metric_reader(self, metric: str):
        """The module whose ``read(ctx)`` gives ``metric``."""
        return _module(_find(self.root, "metrics", f"{metric}.py"), metric)

    def study_module(self):
        return study_module(self.settings["study"], self.root)

    def stream(self, arrays: dict, seed: int, order=None, device="cpu"):
        """The cell's traffic: its mix's stream over ``arrays``."""
        return stream_module(self.traffic["kind"], self.root).Stream(
            self.traffic, arrays, seed, int(self.settings["batch"]), order,
            device)


def _reported(metric: dict, workload: str, e2e_names: set) -> bool:
    ws = metric.get("workloads")
    if ws is not None:
        return workload in ws
    return metric["moves"] in e2e_names


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``: its
    configuration, traffic mix, settings and the metrics it reports."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    entries = [w for w in bench["workloads"] if w["name"] == workload]
    if len(entries) != 1:
        raise KeyError(f"workload {workload!r} is not in "
                       f"{os.path.join(root, 'BENCHMARK.json')}")
    w = entries[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    e2e = [m for m in bench["end_to_end"]
           if m.get("workloads") is None or workload in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reported(m, workload, e2e_names)]
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=_json(os.path.join(root, conf["file"])),
        traffic=_json(_find(root, "traffic", f"{w['traffic']}.json")),
        settings=_json(_find(root, "cells", f"{workload}.json")),
        end_to_end=e2e, per_layer=per_layer, root=root)
