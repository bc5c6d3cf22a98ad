#!/usr/bin/env python3
"""Re-measure the constants of the banded run kernels on one CUDA card.

    python3 tune_dia_spmv.py [out.json]          # from the repository root
    python3 tune_dia_spmv.py --batch [out.json]  # section 3 alone

``csparse3_tpu_torch/csrc/dia_spmv.cu`` fixes the rows per group of the
occupancy index (``kRunRows``) and the rule for the lane-sets per group
(``run_parts``), and ``csparse3_tpu_torch/kernels/dia.py`` fixes
``RUN_SHARE_MAX``; the comments beside them and PERF.md quote the numbers of
this script.  The package has no switch for any of them, so the script makes
its own copies of the CUDA source with the candidate values written in,
builds them with nvcc (all at once) into the git-ignored
``csparse3_tpu_torch/_build/tune/``, and calls their C functions itself.  It
prints one JSON line per measurement and writes them all to ``out.json``
where one is named.

1. Rows per group among 4, 8, 16, 32, each with the source's own rule for the
   lane-sets and with every fixed number of lane-sets that fits a warp, on
   the RCM-ordered Ybus of the 200k-bus grid in float32 and of the 10k-bus
   grid in float64, general and symmetric form: device time per launch of
   the run kernel on one slab set with x (2, n) and of the split-complex
   kernel on two slab sets of that pattern with x (n, 2), on packed run
   values; listed runs and the bytes of index and values.
2. ``RUN_SHARE_MAX``: the package's dense kernel against its run kernel on
   bands of 200,000 rows and 256 diagonals in float32 whose runs are
   occupied at random with a given share, from 2% to 100%: where they cross.
3. The batched split-complex kernel (K scenarios, scenario-minor x, over a
   plan's batch entries): the entries a row whose gathers it stages
   (``kEntryChunk``) and the CTAs an SM its register cap makes room for
   (``kBatchCtasPerSm``), on the RCM-ordered Ybus of the 10k-bus grid in
   float64, symmetric and general form, K = 16 and 256: device time per
   launch, each variant's result bit-equal to the package's own launch, and
   the registers ptxas gives the kernel in float64 and float32 at each
   number of lane-sets P.

Sections 1 and 2 check every result against the dense plain version before
it is timed.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "csparse3_tpu_torch", "csrc", "dia_spmv.cu")
OUT_DIR = os.path.join(ROOT, "csparse3_tpu_torch", "_build", "tune")
ROWS = (4, 8, 16, 32)
SHARES = (0.02, 0.05, 0.1, 0.15, 0.2, 0.3, 0.4, 0.5, 0.75, 1.0)
# (staged entries a row, CTAs an SM) of the batched kernel; the first is the
# source's own
BATCH = ((4, 8), (8, 1), (8, 8), (2, 8), (1, 10))
BATCH_K = (16, 256)
NVCC_ARGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-shared", "-Xcompiler", "-fPIC"]


def variant_source(text, rows, parts):
    """The CUDA source with ``rows`` rows per group and, for ``parts`` > 0,
    that many lane-sets per group whatever the number of rows."""
    marks = [("constexpr int kRunRows = 4;",
              f"constexpr int kRunRows = {rows};"),
             ("  int parts = 1;\n  while (",
              f"  int parts = 1;\n  if ({parts}) return {parts};\n  while (")]
    for old, new in marks:
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE}: expected one {old!r}")
        text = text.replace(old, new)
    return text


def build_variants():
    """{(rows, parts): ctypes library}; parts 0 is the source's own rule."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    procs = {}
    for rows in ROWS:
        for parts in (0, 1, 2, 4, 8):
            if rows * parts > 32:
                continue
            base = os.path.join(OUT_DIR, f"dia_spmv_r{rows}_p{parts}")
            with open(base + ".cu", "w") as f:
                f.write(variant_source(text, rows, parts))
            procs[rows, parts] = (base + ".so", subprocess.Popen(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                 base + ".so", base + ".cu"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lib = ctypes.CDLL(path)
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.dia_spmv_runs.restype = ci
        lib.dia_spmv_runs.argtypes = [ci] * 8 + [vp] * 9
        lib.dia_spmv_runs_split.restype = ci
        lib.dia_spmv_runs_split.argtypes = [ci] * 7 + [vp] * 11
        libs[key] = lib
    return libs


def batch_variant_source(text, chunk, ctas):
    """The CUDA source with ``chunk`` staged entries a row and a register
    cap for ``ctas`` CTAs an SM in the batched kernel."""
    marks = [("constexpr int kEntryChunk = 4;",
              f"constexpr int kEntryChunk = {chunk};"),
             ("constexpr int kBatchCtasPerSm = 8;",
              f"constexpr int kBatchCtasPerSm = {ctas};")]
    for old, new in marks:
        if text.count(old) != 1:
            raise RuntimeError(f"{SOURCE}: expected one {old!r}")
        text = text.replace(old, new)
    return text


def batch_registers(ptxas):
    """{(dtype, P): registers} of the batched kernel in ptxas's report."""
    regs, key = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            key = None
            for t, dtype in (("Id", "float64"), ("If", "float32")):
                for p in (1, 2, 4, 8):
                    if f"dia_entries_split_kernel{t}Li{p}E" in name:
                        key = (dtype, p)
        elif key and "Used" in line and "registers" in line:
            regs[key] = int(line.split("Used")[1].split()[0])
            key = None
    return regs


def build_batch_variants():
    """{(chunk, ctas): (ctypes library, registers)}, built all at once."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    procs = {}
    for chunk, ctas in BATCH:
        base = os.path.join(OUT_DIR, f"dia_spmv_b{chunk}_c{ctas}")
        with open(base + ".cu", "w") as f:
            f.write(batch_variant_source(text, chunk, ctas))
        procs[chunk, ctas] = (base + ".so", subprocess.Popen(
            [nvcc, *NVCC_ARGS, "-Xptxas", "-v", "-o", base + ".so",
             base + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (path, proc) in procs.items():
        out, _ = proc.communicate(timeout=900)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        lib = ctypes.CDLL(path)
        lib.dia_spmv_split_batched.restype = ctypes.c_int
        lib.dia_spmv_split_batched.argtypes = ([ctypes.c_int] * 5
                                               + [ctypes.c_void_p] * 7)
        libs[key] = (lib, batch_registers(out))
    return libs


def time_batch(dev, libs, out):
    """Each variant of the batched kernel on the 10k-bus RCM Ybus in float64,
    symmetric and general form, x (n, K, 2) for K in BATCH_K, over the
    plan's batch entries: bit-equal to the package's own launch, then
    timed."""
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.kernels.bandpoints import scenario_lanes
    from csparse3_tpu_torch.models.grids import rcm_grid, synthetic_grid, ybus
    from csparse3_tpu_torch.models.powerflow import _make_yplan

    Y = ybus(rcm_grid(synthetic_grid(10_000, seed=3))[0])[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    for form in ("symdia", "dia"):
        plan = _make_yplan(Y, form, dev)
        re, im = plan.re, plan.im
        entries = plan.batch_entries()
        m = re.m
        for K in BATCH_K:
            x = torch.rand((m, K, 2), dtype=torch.float64, device=dev)
            ref = kdia.dia_split_cuda(
                re.slabs, im.slabs, x, re.omin, re.symmetric, re.runs,
                (re.run_values, im.run_values), scenario_minor=True,
                entries=entries)
            y = torch.empty_like(ref)
            head = (8, m, K, scenario_lanes(K), kdia.run_parts(m))
            ptrs = [t.data_ptr() for t in entries] + [x.data_ptr(),
                                                      y.data_ptr()]
            for (chunk, ctas), (lib, regs) in libs.items():

                def launch():
                    return lib.dia_spmv_split_batched(*head, *ptrs, stream)

                if launch():
                    raise RuntimeError(f"batch {chunk}/{ctas}: refused")
                if not torch.equal(y, ref):
                    raise AssertionError(f"batch {chunk}/{ctas}: not the "
                                         "package's bits")
                for _ in range(5):
                    launch()
                out.append(dict(
                    what="batch", shape="rcm_ybus_10k_f64", form=form, K=K,
                    staged_entries=chunk, ctas_per_sm=ctas,
                    registers_f64_p8=regs.get(("float64", 8)),
                    ms_per_launch=min(device_ms(launch, 200)
                                      for _ in range(2)),
                    batch_entries=int(entries[1].numel())))
                print(json.dumps(out[-1]), flush=True)
    regs = libs[BATCH[0]][1]
    out.append(dict(what="batch_registers", staged_entries=BATCH[0][0],
                    ctas_per_sm=BATCH[0][1],
                    run_parts_10k=kdia.run_parts(10_000),
                    run_parts_200k=kdia.run_parts(200_000),
                    registers={f"{d} P={p}": r
                               for (d, p), r in sorted(regs.items())}))
    print(json.dumps(out[-1]), flush=True)


def run_lists(slabs, rows, mirror):
    """(ptr, diag) int32: for each group of ``rows`` rows the diagonals whose
    run (or mirror run) of the host (D, m) ``slabs`` holds a nonzero."""
    D, m = slabs.shape
    groups = -(-m // rows)
    gs, ds = [], []
    for d in range(int(mirror), D):
        i = np.flatnonzero(slabs[d]) + (d if mirror else 0)
        g = np.unique(i[i < m] // rows)
        gs.append(g)
        ds.append(np.full(len(g), d, dtype=np.int32))
    g = np.concatenate(gs)
    ptr = np.zeros(groups + 1, dtype=np.int64)
    np.cumsum(np.bincount(g, minlength=groups), out=ptr[1:])
    return ptr.astype(np.int32), np.concatenate(ds)[np.argsort(g, kind="stable")]


def pack(slabs, n, omin, rows, ptr, diag, mirror):
    """(listed runs, rows) values the runs read, zero past an edge."""
    m = slabs.shape[1]
    g = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    i = g[:, None] * rows + np.arange(rows)
    d = diag[:, None].astype(np.int64)
    src = i - d if mirror else i
    col = src if mirror else i + omin + d
    ok = (i < m) & (src >= 0) & (col >= 0) & (col < n)
    return np.where(ok, slabs[d, np.clip(src, 0, m - 1)], 0).astype(slabs.dtype)


def device_ms(fn, reps):
    """Device ms per call of ``reps`` calls queued behind a spin kernel, so
    that the host's launch time is not in the way."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    torch.cuda._sleep(int(max(40e6, reps * 5e5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(y, ref, what):
    err = float((y - ref).abs().max())
    if not err <= 1e-4 * float(ref.abs().max()):
        raise AssertionError(f"{what}: kernel disagrees by {err}")


def rcm_ybus_part(n_bus, seed, dtype):
    """The real part of the RCM-ordered Ybus as a CSC of ``dtype``."""
    from csparse3_tpu_torch.linalg.ordering import rcm
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus
    from csparse3_tpu_torch.types import CSC

    Y, _, _ = ybus(synthetic_grid(n_bus, seed=seed))
    p = rcm(Y)
    ip, ix, dt = Y[p, p].np_arrays()
    return CSC(Y.m, Y.n, ip, ix, np.ascontiguousarray(dt.real).astype(dtype))


def time_rows(label, a, dev, libs, reps, out):
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.ops.matvec import DIAPlan, SymDIAPlan

    stream = torch.cuda.current_stream(dev).cuda_stream
    for sym in (False, True):
        plan = (SymDIAPlan(a, tol=1e-6, device=dev) if sym
                else DIAPlan(a, device=dev))
        omin, (D, m), n = plan.omin, plan.slabs.shape, a.n
        ra = plan.slabs.cpu().numpy()
        size = ra.dtype.itemsize
        x = torch.rand((2, n), dtype=plan.slabs.dtype, device=dev)
        xn2 = x.T.contiguous()
        ref = kdia.dia_spmv_plain(plan.slabs, x, omin, sym)
        # a second slab set of the same pattern, im = re / 2
        ref2 = torch.stack([ref[0] - 0.5 * ref[1], ref[1] + 0.5 * ref[0]])
        dense_ms = device_ms(
            lambda: kdia.dia_spmv_cuda(plan.slabs, x, omin, sym), reps // 4)
        for rows in ROWS:
            lists = [run_lists(ra, rows, mir) for mir in (False, True)[:1 + sym]]
            index = [torch.as_tensor(t, device=dev) for pd in lists for t in pd]
            vals = [torch.as_tensor(pack(ra, n, omin, rows, *pd, mir),
                                    device=dev)
                    for mir, pd in enumerate(lists)]
            half = [v * 0.5 for v in vals]
            ip = [t.data_ptr() for t in index] + [None] * (4 - len(index))
            vp = [t.data_ptr() for t in vals] + [None] * (2 - len(vals))
            hp = [t.data_ptr() for t in half] + [None] * (2 - len(half))
            y = torch.empty((2, m), dtype=x.dtype, device=dev)
            head = (size, int(sym), m, n, omin)
            groups = -(-m // rows)
            listed = sum(len(pd[1]) for pd in lists)
            for parts in (0, 1, 2, 4, 8):
                lib = libs.get((rows, parts))
                if lib is None:
                    continue

                def one():
                    return lib.dia_spmv_runs(
                        *head, 2, rows, groups, *ip, *vp, x.data_ptr(),
                        y.data_ptr(), stream)

                def split():
                    return lib.dia_spmv_runs_split(
                        *head, rows, groups, *ip, vp[0], hp[0], vp[1], hp[1],
                        xn2.data_ptr(), y.data_ptr(), stream)

                for fn, want in ((one, ref), (split, ref2)):
                    if fn():
                        raise RuntimeError(f"{label}: launch refused")
                    check(y, want, f"{label} rows={rows} parts={parts}")
                    for _ in range(5):
                        fn()
                out.append(dict(
                    what="run_rows", shape=label, symmetric=sym,
                    dtype=str(x.dtype), D=D, m=m, run_rows=rows,
                    parts=parts or "rule",
                    ms_per_launch=min(device_ms(one, reps) for _ in range(2)),
                    split_ms_per_launch=min(device_ms(split, reps)
                                            for _ in range(2)),
                    dense_kernel_ms=dense_ms, listed_runs=listed,
                    index_bytes=sum(t.numel() * 4 for t in index),
                    run_value_bytes=listed * rows * size))
                print(json.dumps(out[-1]), flush=True)
        del plan, ra
        torch.cuda.empty_cache()


def time_shares(dev, out, m=200_000, D=256):
    """The package's dense kernel against its run kernel on bands whose runs
    are occupied at random."""
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia

    rows = kdia.RUN_ROWS
    rng = np.random.RandomState(0)
    groups = -(-m // rows)
    x = torch.rand((2, m), dtype=torch.float32, device=dev)
    omin = -(D // 2)
    for share in SHARES:
        keep = rng.rand(D, groups) < share
        ra = (np.repeat(keep, rows, axis=1)[:, :m]
              * rng.rand(D, m).astype(np.float32))
        slabs = torch.as_tensor(ra, device=dev)
        runs = tuple(torch.as_tensor(t, device=dev)
                     for t in kdia.run_index(ra))
        vals = kdia.pack_runs(slabs, m, omin, False, runs)
        check(kdia.dia_spmv_cuda(slabs, x, omin, False, runs, vals),
              kdia.dia_spmv_plain(slabs, x, omin), f"share {share}")

        def dense():
            return kdia.dia_spmv_cuda(slabs, x, omin)

        def walk():
            return kdia.dia_spmv_cuda(slabs, x, omin, False, runs, vals)

        t = [device_ms(fn, 50) for fn in (dense, walk, walk, dense)]
        out.append(dict(
            what="run_share", m=m, D=D, dtype="torch.float32", run_rows=rows,
            share=runs[1].numel() / (groups * D),
            dense_kernel_ms=min(t[0], t[3]), run_kernel_ms=min(t[1], t[2])))
        print(json.dumps(out[-1]), flush=True)
        del slabs, runs, vals


def main(argv=()):
    import torch

    if not torch.cuda.is_available():
        print("tune_dia_spmv: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(f"card: {smi} | torch {torch.__version__}", flush=True)
    batch_only = "--batch" in argv
    argv = [a for a in argv if a != "--batch"]
    out = []
    with torch.inference_mode():
        if not batch_only:
            libs = build_variants()
            time_rows("rcm_ybus_10k_f64",
                      rcm_ybus_part(10_000, 3, np.float64), dev, libs, 200,
                      out)
            time_rows("rcm_ybus_200k_f32",
                      rcm_ybus_part(200_000, 0, np.float32), dev, libs, 200,
                      out)
            time_shares(dev, out)
        time_batch(dev, build_batch_variants(), out)
    if argv:
        with open(argv[0], "w") as f:
            json.dump(dict(card=smi, results=out), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
