"""Shared by the benchmark's tests: a temporary checkout root that holds a
``BENCHMARK.json`` of the real cells cut to a few hundred buses and a
batch of 4, with the real cells' limits and traffic; small grids of the
configurations' generator."""

import copy
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def real_bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def real_cell(name):
    with open(os.path.join(PKG, "cells", f"{name}.json")) as f:
        return json.load(f)


def write(path, obj):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        if isinstance(obj, str):
            f.write(obj)
        else:
            json.dump(obj, f)


def cut(cfg, n_bus):
    """The configuration ``cfg`` with its generator's counts scaled to
    ``n_bus`` buses."""
    cfg = copy.deepcopy(cfg)
    g = cfg["generator"]
    r = n_bus / cfg["n_bus"]
    cfg["n_bus"] = n_bus
    g["n_branch"] = max(int(g["n_branch"] * r), n_bus)
    g["n_gen"] = max(int(g["n_gen"] * r), 2)
    g["strips"] = max(int(g["strips"] * r ** 0.5), 1)
    for lev in g["levels"]:
        lev["buses"] = max(int(lev["buses"] * r), 4)
    cfg.pop("expect", None)
    return cfg


def small_grid(n_bus, name="grid10k"):
    """A grid of configuration ``name``'s generator cut to ``n_bus``."""
    from gridbench.grid import make_grid

    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        return make_grid(cut(json.load(f), n_bus))


def tiny_root(tmp, n_bus=300, batch=4):
    """A root whose BENCHMARK.json names the real cells on tiny grids."""
    bench = copy.deepcopy(real_bench())
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = cut(json.load(f), n_bus)
        c["file"] = f"gridbench/configs/tiny_{c['name']}.json"
        write(os.path.join(tmp, c["file"]), cfg)
    for w in bench["workloads"]:
        cell = real_cell(w["name"])
        cell["batch"] = batch
        cell["keep_per_batch"] = min(cell["keep_per_batch"], batch)
        cell["trace_batches"] = 2
        write(os.path.join(tmp, "gridbench", "cells", f"{w['name']}.json"),
              cell)
    write(os.path.join(tmp, "BENCHMARK.json"), bench)
    return str(tmp)


ECHO_STUDY = '''import numpy as np
import torch


class Study:
    item = "snapshot"
    order = None

    def __init__(self, arrays, settings, device):
        self.device = device

    def run(self, payload):
        x = torch.as_tensor(payload, device=self.device)
        return {"y": (2 * x).cpu().numpy()}

    def tally(self, out):
        return {"y": out["y"]}

    def keep(self, out, rows, payload):
        return {"y": out["y"][rows], "x": payload[rows]}

    def counters(self):
        return {}


def numbers(arrays, settings, kept, tally, seed):
    return {"gap": float(np.abs(kept["y"] - 2 * kept["x"]).max()),
            "failed": 0}
'''

RAMP_STREAM = '''import numpy as np


class Stream:
    item = "snapshot"

    def __init__(self, p, arrays, seed, batch, order=None, device="cpu"):
        self.batch, self.step = batch, p["step"]

    def items(self, b):
        return np.arange(b * self.batch, (b + 1) * self.batch)

    def payload(self, b):
        return self.step * self.items(b).astype(np.float64)
'''


def dummy_root(tmp):
    """A tiny root with a dummy configuration, traffic mix of a new kind
    (``streams/ramp.py``), study (``studies/echo.py``) and metric, each
    added as a file of its own beside the others."""
    root = tiny_root(tmp)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append({"name": "dummy", "source": "a test",
                         "file": "gridbench/configs/dummy.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "dummy.wave", "config": "dummy",
                           "traffic": "wave", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "dummy_count", "unit": "items",
                           "better": "higher", "source": "program_counter",
                           "layer": "study entry",
                           "moves": "pf_snapshots_per_s",
                           "workloads": ["dummy.wave"]})
    for m in b["end_to_end"]:
        if m["name"] == "pf_snapshots_per_s":
            m["workloads"].append("dummy.wave")
    write(os.path.join(root, "BENCHMARK.json"), b)
    with open(os.path.join(PKG, "configs", "grid10k.json")) as f:
        cfg = cut(json.load(f), 150)
    cfg["name"] = "dummy"
    write(os.path.join(root, "gridbench/configs/dummy.json"), cfg)
    write(os.path.join(root, "gridbench/traffic/wave.json"),
          {"kind": "ramp", "step": 0.25})
    write(os.path.join(root, "gridbench/streams/ramp.py"), RAMP_STREAM)
    write(os.path.join(root, "gridbench/studies/echo.py"), ECHO_STUDY)
    write(os.path.join(root, "gridbench/cells/dummy.wave.json"),
          {"study": "echo", "batch": 4, "keep_per_batch": 2,
           "trace_batches": 2, "limits": {"gap": 0.0, "failed": 0}})
    write(os.path.join(root, "gridbench/metrics/dummy_count.py"),
          "def read(ctx):\n    return ctx['items'] + 0.5\n")
    return root
