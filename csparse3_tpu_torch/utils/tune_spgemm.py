"""Re-measure the tile size rule of the SpGEMM numeric kernel on one card.

    python3 -m csparse3_tpu_torch.utils.tune_spgemm [out.json] [--also SOURCE ...]

``csrc/spgemm_numeric.cu`` gives each thread V consecutive outputs of a
256 x V output tile, V by a size rule (``outputs_per_thread``); the comment
beside the rule and PERF.md quote this script.  The package has no switch
for V, so the script writes copies of the source whose rule returns 1, 2 or
4 whatever the size, and probes of what bounds the kernel (``VARIANTS``),
builds them with nvcc (all at once) into the git-ignored
``csparse3_tpu_torch/_build/tune/``, and calls their C function itself;
``--also`` adds other sources with the same C function (an earlier version
of the kernel, unpacked beside the checkout) to time in the same run.  On
the float32 numeric pass of ``C @ C.T`` for the connectivity matrices of
the 3000-bus and 200k-bus synthetic grids and ``A @ A.T`` for the random
10k x 10k matrix at 0.1% density (the shapes of ``chip_smoke.py``), and on
a plan of one output (the launch floor), it checks every variant but the
probes against the plain version within the per-output rounding bound and
then times all of them, in turn and then in the reverse order: device ms
per launch by CUDA events around launches queued behind a spin kernel, the
better of the two.  Prints one JSON line per measurement and writes them
all to ``out.json`` where one is named.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import scipy.sparse as sp
import torch

from .build import BUILD_DIR, CSRC_DIR, build_cuda_library

SOURCE = os.path.join(CSRC_DIR, "spgemm_numeric.cu")
OUT_DIR = os.path.join(BUILD_DIR, "tune")
RULE = "int outputs_per_thread(int out_nnz) {\n"
# name -> [(text in the source, its replacement)]: V forced to 1, 2 or 4,
# then probes of what bounds the kernel, at the source's own V: the value
# gathers confined to the first 1024 entries (L1 hits, the same
# instructions and registers); seg_ptr and the maps read through the
# caches like the values instead of streamed; the output stored through
# the caches
LAUNCH = "  if (outputs_per_thread(out_nnz) == 2)\n"
VARIANTS = {f"V={v}": [(RULE, f"{RULE}  if ({v}) return {v};\n")]
            for v in (1, 2)}
VARIANTS["V=4"] = [(RULE, f"{RULE}  if (4) return 4;\n"), (LAUNCH, (
    "  if (outputs_per_thread(out_nnz) == 4)\n    return launch_v<T, 4>"
    "(out_nnz, seg_ptr, pa, pb, a, b, data, stream);\n" + LAUNCH))]
VARIANTS["probe_local_gathers"] = [
    (f"ld({x} + {i}[k])", f"ld({x} + ({i}[k] & 1023))")
    for x, i in (("a", "ia0"), ("b", "ib0"), ("a", "ia1"), ("b", "ib1"))]
VARIANTS["probe_cached_maps"] = [
    (f"__ldcs({x} + {t})", f"__ldg({x} + {t})") for x, t in (
        ("seg_ptr", "ok"), ("seg_ptr", "ok + 1"), ("pa", "s[k]"),
        ("pb", "s[k]"), ("pa", "s[k] + 1"), ("pb", "s[k] + 1"))]
VARIANTS["probe_cached_store"] = [("store(data + ok, acc);",
                                   "data[ok] = acc;")]


def variant_source(text, subs):
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE}: expected one {old!r}")
        text = text.replace(old, new)
    return text


def build_variants(also=()):
    """{name: ctypes library}: "rule" is the source as it is, then the
    VARIANTS, then each path of ``also`` (another source with the same C
    function, such as an earlier version of this one)."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    sources = {name: variant_source(text, subs)
               for name, subs in VARIANTS.items()}
    for path in also:
        with open(path) as f:
            sources[os.path.relpath(path)] = f.read()
    procs = {}
    for k, (name, src) in enumerate(sources.items()):
        base = os.path.join(OUT_DIR, f"spgemm_numeric_{k}")
        with open(base + ".cu", "w") as f:
            f.write(src)
        procs[name] = (base + ".so", subprocess.Popen(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", base + ".so",
             base + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {"rule": ctypes.CDLL(build_cuda_library("spgemm_numeric"))}
    for name, (path, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(path)
    for lib in libs.values():
        lib.spgemm_numeric.restype = ctypes.c_int
        lib.spgemm_numeric.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
    return libs


def queued_ms(fn, reps):
    """Device ms per call of ``reps`` calls enqueued behind a spin kernel."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(40e6, reps * 5e5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def shapes(dev):
    """{name: (seg_ptr, pa, pb, gid, a, b)} on ``dev``, float32 values."""
    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.models.grids import connectivity, synthetic_grid

    def conn(n, seed):
        Cf, Ct = connectivity(synthetic_grid(n, seed=seed))
        return Cf - Ct

    mats = dict(
        conn3000=conn(3000, 1),
        rand10k=pt.CSC.from_scipy(sp.random(
            10_000, 10_000, density=1e-3, format="csc",
            random_state=np.random.RandomState(0))),
        conn200k=conn(200_000, 0))
    out = {}
    for name, A in mats.items():
        plan = pt.spgemm_symbolic(A, A.T, device=dev)
        out[name] = (plan.seg_ptr, plan.pa_s, plan.pb_s, plan.gid,
                     torch.as_tensor(A.np_arrays()[2].astype(np.float32),
                                     device=dev),
                     torch.as_tensor(A.T.np_arrays()[2].astype(np.float32),
                                     device=dev))
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    out["one_output"] = (torch.tensor([0, 1], dtype=torch.int32, device=dev),
                         one, one, one, torch.ones(1, device=dev),
                         torch.ones(1, device=dev))
    return out


def main(argv):
    """argv: [out.json] [--also SOURCE ...]"""
    from csparse3_tpu_torch.kernels.spgemm import (outputs_per_thread,
                                                    spgemm_numeric_plain)

    if not torch.cuda.is_available():
        print("tune_spgemm: needs a CUDA card", file=sys.stderr)
        return 1
    args = argv[1:]
    also = args[args.index("--also") + 1:] if "--also" in args else []
    out_path = args[0] if args and args[0] != "--also" else None
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    libs = build_variants(also)
    rows = []
    for name, (seg_ptr, pa, pb, gid, a, b) in shapes(dev).items():
        n_out = seg_ptr.numel() - 1
        stream = torch.cuda.current_stream(dev).cuda_stream
        plain = spgemm_numeric_plain(gid, pa, pb, a, b, n_out)
        absum = spgemm_numeric_plain(gid, pa, pb, a.abs().double(),
                                     b.abs().double(), n_out)
        bound = 2 * (seg_ptr.diff().double() + 1) * 2.0 ** -24 * absum
        launches, times = {}, {}
        for v, lib in libs.items():
            data = torch.empty(n_out, device=dev)

            def launch(lib=lib, data=data):
                err = lib.spgemm_numeric(
                    4, 0, n_out, seg_ptr.data_ptr(), pa.data_ptr(),
                    pb.data_ptr(), a.data_ptr(), b.data_ptr(),
                    data.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            launch()
            torch.cuda.synchronize()
            if not v.startswith("probe") and not (
                    (data - plain).abs().double() <= bound).all():
                raise AssertionError(f"{name} {v}: outside the bound")
            for _ in range(10):
                launch()
            launches[v] = launch
        # every variant in turn, then in the reverse order: one card
        for v in list(libs) + list(libs)[::-1]:
            times.setdefault(v, []).append(queued_ms(launches[v], 200))
        for v, t in times.items():
            rec = dict(shape=name, outputs=n_out, products=int(pa.numel()),
                       variant=v, V=outputs_per_thread(n_out)
                       if not v.startswith("V=") else int(v[2:]),
                       ms=min(t), runs=t, card=smi)
            rows.append(rec)
            print(json.dumps(rec), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
