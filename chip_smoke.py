#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card and check them.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure raises, and the script exits non-zero; each prints its
seconds):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build:  compiles every library from this checkout into
           csparse3_tpu_torch/_build/, all at once (nvcc for sm_90a:
           csrc/bandpoints.cu, csrc/dia_spmv.cu, csrc/triad.cu,
           csrc/spgemm_numeric.cu, csrc/bsr_spmm.cu; g++:
           native/host_ext.cpp + native/lu_sn.cpp) and prints the seconds
           each took.
3. triad:  the triad kernel against its plain version (bit for bit), then
           ``measure_hbm_bw``: the card's measured memory rate and its share
           of the published 3.35 TB/s.
4. kernel: the band+points SpMV on the 200k-bus synthetic Ybus: the CUDA
           kernel against its plain PyTorch version on the card and against
           scipy complex128 on the host, for the default plan and for an
           offset-group plan (group_span=512), which must make one launch
           per call, like the default plan, and give the same bits; device
           times of the kernel alone and of the plain version (CUDA events
           around calls queued behind a spin kernel), the kernel's time
           with a cold L2, and the one library call for the same function
           (torch.sparse CSR complex64 @ x).
5. dia:    the DIA SpMV on the RCM-ordered 200k-bus Ybus (D = 1885
           diagonals), float32: ``SplitDIA`` and ``SplitSymDIA``, whose two
           real slab sets share an occupancy index and go through the
           split-complex run kernel in one launch, against the dense plain
           version, the plain walk of the index and scipy complex128, row
           by row within the rounding bound of the sums, bit-equal on a
           second call and to one launch per slab set; the dense kernel on
           the raw slabs held to the same bound; the index's size and share;
           times, the bytes each route must move, shares of the published
           and of the measured memory rate, and the library call.
6. newton: NewtonPowerFlow(synthetic_grid(10_000, seed=3), spmv='bandpoints',
           solver='level', tol=5e-5) on the card from flat start: it must
           converge, its state must give a host float64 scipy mismatch
           <= 1e-4, the kernel must have launched once per mismatch
           evaluation, and the state must agree with the port's own
           float64 spmv='ell' solve (the same solver with the 'ell' plan in
           place of the kernel's: the Jacobian pattern and so the host
           factorization and refactor plan are the same, built once).
7. banded: the same grid in RCM order (``rcm_grid``):
           NewtonPowerFlow(spmv='dia') in float64 must converge to 1e-10,
           give a host float64 mismatch <= 1e-8, launch the DIA kernel once
           per slab set per mismatch evaluation and agree with the 'ell'
           state of phase 6 mapped by vm_old[perm] = vm_new;
           FastDecoupled(spmv='symdia') and ('dia') must converge to 1e-8
           and agree with that Newton state; dc_power_flow must match scipy
           spsolve on the host.  Prints the dense tails ``solve_plan``
           chose.  Then the DIA run kernels alone at the shape these solves
           launch them (float64; one slab set with the stacked (2, n)
           input, and both sets in the split-complex launch the solves
           make), general and symmetric form: against both plain versions
           and scipy row by row within the rounding bound, with their
           times, the dense kernel's on the raw slabs, the plain versions'
           and the library call's.
8. ieee14: phase 6 on ieee14().
9. spgemm: the sparse-product path on three matrices: C = Cf - Ct of
           synthetic_grid(3000, seed=1) (the GridCal flow), the random
           10k x 10k matrix at 0.1% density of BASELINE config 2, and C of
           the 200k-bus grid.  Host: ``Cf - Ct``, ``C @ C.T``, ``gram``,
           ``add(gram(A), A).t()`` against scipy; ``spgemm_symbolic`` and
           ``gram_symbolic`` (seconds printed: paid once per pattern).
           Card: ``plan.numeric`` in float32 (the SpGEMM numeric kernel,
           one launch per call) against its plain version and against scipy
           float64 output by output within the rounding bound of its sum,
           the pattern equal to scipy's exactly; ``GramPlan.numeric``,
           ``spgemm_device`` and the host products agree; times of kernel,
           plain version and the library call (torch.sparse.mm of two CSR
           tensors, symbolic and numeric together) beside the kernel's byte
           bound, the least-bytes bound of any layout and the launch floor
           (the kernel on a one-output plan); wall and queued times of the
           device ESC product (``ESCSpGEMM``).
10. bsr:   the block product ``Y = A @ X``: the 16384^2 matrix of 32 x 32
           blocks (6 per block row) with X (16384, 1024), and
           ``spmm(B, X, block=(8, 128))`` for B = imag(Ybus) of the 200k-bus
           grid in float32 with X (200000, 1024); the BSR SpMM kernel
           through the containers' column lists (the occupied columns of
           each block) and without them, against the plain version, the
           plain walk of the lists and scipy float64 row by row within
           the rounding bound, bit-equal on a second launch, k = 1 and
           k = 130 and empty block rows at a small shape,
           ``BSRMatMatPlan(A, A).numeric`` against scipy's
           ``A @ A``; times of kernel, plain version, the library call
           (torch.sparse BSR ``@ X``) and the entry-stream ``spmm``.

Prints one JSON line of kernel records, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np

N_KERNEL = 200_000   # buses of the SpMV kernel phases
N_SOLVE = 10_000      # buses of the solver phases

# published rates of one H100 SXM (NVIDIA data sheet): float32 and float64
# outside the tensor cores; the device-memory rate is the port's own
# constant (utils.roofline.H100_HBM_BYTES_PER_S), read once the card is found
HBM_BYTES_PER_S = None
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

# kernel vs plain / scipy: float32 sums of a handful of complex products
# per row, in different orders; 5e-6 of max|y| is ~40 float32 ulps
SPMV_REL = 5e-6
# bandpoints (float32 SpMV, stops at mismatch <= 5e-5) vs ell (float64)
STATE_ATOL = 1e-4
HOST_MISMATCH = 1e-4
# spmv='dia' is float64 end to end and stops at mismatch <= 1e-10; the host
# recomputes the mismatch with another summation order (~1e-13 apart)
DIA_HOST_MISMATCH = 1e-8
# two float64 Newton solves of one grid, both converged to 1e-10
DIA_STATE_ATOL = 1e-8
# fast-decoupled stops at mismatch/|V| <= 1e-8; the state error is that
# residual times the inverse Jacobian's norm (some 1e1 per unit here)
FDPF_STATE_ATOL = 1e-6
# dc_power_flow against scipy spsolve, both float64 direct solves
DC_RTOL = 1e-9


def log(*a):
    print(*a, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps):
    """Device ms per call of ``reps`` back-to-back calls, without the host
    in the way: the calls are enqueued while a spin kernel keeps the card
    busy, so they run one behind the other, and CUDA events on the stream
    bracket them.  For a call of one short kernel this is its device time
    plus the gap between two launches.  Only for calls that do not wait for
    the device themselves: such a call would sit out the spin kernel."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    # ~20 ms, or 0.25 ms for every call: the host gets ahead meanwhile
    torch.cuda._sleep(int(max(40e6, reps * 5e5)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps):
    """Host ms per call of ``reps`` calls, the device drained at the end."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def profiler_note(fn, reps, pattern):
    """What torch.profiler recorded of ``reps`` calls, as text.  Late in a
    long process it drops records (after the 86k-launch Newton profile it
    kept 27 of 50 launches, then none), so nothing is decided by it here."""
    _, busy, n, by = device_profile(fn, reps)
    recs = [v for k, v in by.items() if pattern in k]
    count = sum(c for c, _ in recs)
    if count == 0:
        return f"torch.profiler recorded none of the {reps} launches"
    return (f"torch.profiler: {sum(t for _, t in recs) / count * 1e3:.6f} ms "
            f"per launch over {count} of {reps} launches recorded, {n} "
            f"kernels in all")


def device_profile(fn, reps):
    """Run ``fn`` ``reps`` times under torch.profiler.  Returns (wall s,
    device-busy s as the union of kernel intervals, kernel launches,
    {kernel name: (count, device s)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        c, s = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, s + (b - a) * 1e-6)
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, busy * 1e-6, len(spans), by_name


def host_mismatch(grid, Y, vm, va):
    from csparse3_tpu_torch.models.powerflow import sbus

    v = vm * np.exp(1j * va)
    mis = v * np.conj(Y.to_scipy().tocsr() @ v) - sbus(grid)
    f = np.concatenate([mis.real[np.concatenate([grid.pv, grid.pq])],
                        mis.imag[grid.pq]])
    return float(np.abs(f).max())


def bound_record(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """bound_ms (the larger of bytes over the memory rate and operations
    over the rate of their type, float32 unless given) and which of the two
    it is."""
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return dict(bound_ms=max(tb, tf),
                bound_by="bytes" if tb >= tf else "operations")


def run_route_bytes(plan, *io):
    """What the run kernel must move for one product of the split-complex
    banded ``plan``: the packed values of each slab set's listed runs, the
    shared index once, and each tensor of ``io`` once.  Returns (bytes,
    listed runs over both sets, index bytes)."""
    from csparse3_tpu_torch.utils.roofline import plan_bytes

    listed = sum(t.numel() for p in (plan.re, plan.im) for t in p.runs[1::2])
    index = sum(t.numel() * t.element_size() for t in plan.re.runs)
    return plan_bytes(plan, *io), listed, index


def nonzero_bytes(re, im, *io):
    """What a product with the complex band ``re + 1j*im`` needs at the
    least, whatever the layout: each slab set's nonzero values, one int32
    position for every entry either set holds (the two share them), and each
    tensor of ``io`` once.  The run route moves more than this: a listed run
    is streamed whole, zeros included.  Returns (bytes, entries)."""
    entries = int(((re.slabs != 0) | (im.slabs != 0)).sum())
    values = sum(int(p.slabs.count_nonzero()) for p in (re, im))
    return (values * re.slabs.element_size() + 4 * entries + sum(
        t.numel() * t.element_size() for t in io)), entries


def library_spmv_ms(Y, xr_t, xi_t, yk, reps=50):
    """Device ms of the one library call for a complex SpMV: a
    torch.sparse CSR complex64 matrix times the complex64 vector.  It is
    checked against the kernel's result and used nowhere in the port."""
    import torch

    csr = Y.to_scipy().tocsr().astype(np.complex64)
    A = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64), device=xr_t.device),
        torch.as_tensor(csr.indices.astype(np.int64), device=xr_t.device),
        torch.as_tensor(csr.data, device=xr_t.device), size=csr.shape)
    x = torch.complex(xr_t.float(), xi_t.float())
    y = A @ x
    scale = float(yk[0].abs().max())
    err = max(float((y.real - yk[0]).abs().max()),
              float((y.imag - yk[1]).abs().max()))
    if err > 4 * SPMV_REL * scale:
        raise AssertionError(f"library CSR product disagrees: {err}")
    for _ in range(10):
        A @ x
    _, busy, _, _ = device_profile(lambda: A @ x, reps)
    return busy / reps * 1e3


def kernel_phase(dev):
    """The band+points SpMV at 200k buses: the default plan and an offset-
    group plan, each one launch per call.  Returns {label: record}."""
    import torch

    from csparse3_tpu_torch import SplitBandPoints
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus

    t0 = time.perf_counter()
    Y, _, _ = ybus(synthetic_grid(N_KERNEL, seed=0))
    n = Y.n
    rng = np.random.RandomState(0)
    xr, xi = rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    z = Y.to_scipy() @ (xr.astype(np.float64) + 1j * xi)
    z2 = np.stack([z.real, z.imag])
    xr_t, xi_t = torch.as_tensor(xr, device=dev), torch.as_tensor(xi, device=dev)
    x2 = torch.stack([xr_t, xi_t])
    out = {}
    for label, kw in (("default", {}), ("groups", dict(group_span=512))):
        plan = SplitBandPoints(Y, device=dev, **kw)
        yk = torch.stack(plan(xr_t, xi_t))
        torch.cuda.synchronize()
        if plan.kernel_launches != 1:
            raise AssertionError(f"{label}: {plan.kernel_launches} launches "
                                 f"for one call ({plan.n_groups} groups)")
        if label == "groups":
            # the groups ride in the one launch over the default plan's
            # lists: the same bits
            if plan.n_groups < 2:
                raise AssertionError("groups: one offset group only")
            if not torch.equal(yk, out["default"]["y"]):
                raise AssertionError("groups: the grouped plan's result "
                                     "differs from the default plan's")
        yp = torch.stack(plan.plain(xr_t, xi_t))
        scale = float(yp.abs().max())
        abs_plain = float((yk - yp).abs().max())
        abs_scipy = float(np.abs(yk.cpu().numpy() - z2).max())
        log(f"kernel[{label}]: n={n} nnz={Y.nnz} heavy_diagonals="
            f"{plan.core_ndiag} groups={plan.n_groups} launches_per_call="
            f"{plan.kernel_launches} rel_err_vs_plain={abs_plain / scale:.3e} "
            f"rel_err_vs_scipy_c128={abs_scipy / scale:.3e} "
            f"bound={SPMV_REL:.0e}"
            + (" equal_to_default=True" if label == "groups" else ""))
        if abs_plain > SPMV_REL * scale or abs_scipy > SPMV_REL * scale:
            raise AssertionError(f"{label}: kernel disagrees")
        y = torch.empty_like(yk)

        def kernel():  # one launch on a prepared x (2, n): the kernel alone
            plan._launch(x2, y)

        def plain():
            plan.plain(xr_t, xi_t)

        for _ in range(20):
            kernel()
            plain()
        # plain, kernel, kernel, plain: one card, one call
        t = [queued_ms(plain, 200), queued_ms(kernel, 400),
             queued_ms(kernel, 400), queued_ms(plain, 200)]
        ms, plain_ms = min(t[1], t[2]), min(t[0], t[3])
        wrapper_ms = cuda_ms(lambda: plan(xr_t, xi_t), 200)
        note = profiler_note(kernel, 50, "band_points_kernel")
        # what the kernel reads (slabs, offsets, point lists, x) and writes
        # (y), each once; 8 float operations per complex nonzero
        ptr, col, val = plan._kernel_lists()
        nbytes = sum(x.numel() * x.element_size() for x in (
            plan.slabs, plan.offs_t, ptr, col, val, xr_t, xi_t, yk))
        flops = 8 * (plan.slabs[0].count_nonzero().item() + col.numel())
        rec = dict(abs_err=abs_plain, ms=ms, plain_ms=plain_ms,
                   n_groups=plan.n_groups, launches_per_call=1,
                   wrapper_ms=wrapper_ms, **bound_record(nbytes, flops))
        log(f"kernel[{label}]: kernel_device_ms_per_launch={ms:.6f} "
            f"plain_device_ms_per_call={plain_ms:.6f} (cuda events around "
            f"calls queued behind a spin kernel; runs plain,kernel,kernel,"
            f"plain = {t}) wrapper_ms_per_call={wrapper_ms:.6f} (cuda "
            f"events, host in the way; the wrapper also stacks x) "
            f"bytes_per_call={nbytes} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}); {note}")
        if label == "default":
            rec["library_ms"] = library_spmv_ms(Y, xr_t, xi_t, yk)
            # cold L2: a write of 128 MB (2.5x the L2) before each launch,
            # less the write's own time
            flush = torch.empty(32 * 2 ** 20, device=dev)
            for _ in range(3):
                flush.fill_(1.0)
                kernel()
            both = min(queued_ms(lambda: (flush.fill_(1.0), kernel()), 100)
                       for _ in range(2))
            fill = min(queued_ms(lambda: flush.fill_(1.0), 100)
                       for _ in range(2))
            rec["cold_l2_ms"] = both - fill
            log(f"kernel[default]: library_csr_c64_device_ms_per_call="
                f"{rec['library_ms']:.6f} cold_l2_kernel_ms="
                f"{rec['cold_l2_ms']:.6f} (a 128 MB write before each "
                f"launch: {both:.6f} ms, the write alone {fill:.6f} ms)")
            del flush
        else:
            rec["library_ms"] = out["default"]["library_ms"]
        rec["y"] = yk
        out[label] = rec
    for rec in out.values():
        del rec["y"]
    log(f"kernel: phase seconds {time.perf_counter() - t0:.1f}")
    return out


def build_phase():
    """Every library at once: one compiler process per source."""
    from concurrent.futures import ThreadPoolExecutor

    from csparse3_tpu_torch.kernels import bandpoints, bsr_spmm, dia, spgemm
    from csparse3_tpu_torch.native import host_ext
    from csparse3_tpu_torch.utils import roofline

    def timed(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    loads = dict(nvcc_bandpoints_s=bandpoints.load_cuda_library,
                 nvcc_dia_spmv_s=dia.load_cuda_library,
                 nvcc_triad_s=roofline.load_cuda_library,
                 nvcc_spgemm_numeric_s=spgemm.load_cuda_library,
                 nvcc_bsr_spmm_s=bsr_spmm.load_cuda_library,
                 gxx_host_ext_s=host_ext.load)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(loads)) as pool:
        secs = dict(zip(loads, pool.map(timed, loads.values())))
    log("build: " + " ".join(f"{k}={v:.2f}" for k, v in secs.items())
        + f" (started together) phase seconds {time.perf_counter() - t0:.1f}")


def triad_phase(dev):
    import torch

    from csparse3_tpu_torch.utils import roofline

    t0 = time.perf_counter()
    n = 1 << 28  # 1 GiB of float32 in, 1 GiB out: far beyond the 50 MB L2
    a = torch.rand(n, dtype=torch.float32, device=dev)
    s = torch.full((1,), 1.2345678, dtype=torch.float32, device=dev)
    # the ragged end (n % 4 != 0) and the full size; the kernel rounds the
    # product and the sum separately, as the plain version: bound 0
    err = 0.0
    for view in (a[: 4 * 1000 + 3], a):
        o, ref = roofline.triad(view, s), roofline.triad_plain(view, s)
        torch.cuda.synchronize()
        err = max(err, float((o - ref).abs().max()))
        if not torch.equal(o, ref):
            raise AssertionError(f"triad disagrees with its plain version "
                                 f"by {err} (bound 0: same roundings)")
    half = torch.tensor(0.5, device=dev)
    lib = torch.add(half, a, alpha=1.2345678)  # s rounded to float32 inside
    lib_err = float((lib - ref).abs().max())
    o = torch.empty_like(a)
    for _ in range(3):
        roofline.triad_cuda(a, s, out=o)
    ms = cuda_ms(lambda: roofline.triad_cuda(a, s, out=o), 10)
    del lib, ref
    plain_ms = cuda_ms(lambda: roofline.triad_plain(a, s), 5)
    lib_ms = cuda_ms(lambda: torch.add(half, a, alpha=1.2345678), 5)
    nbytes = 2 * n * 4
    rec = dict(abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               **bound_record(nbytes, 2 * n))
    log(f"triad: n={n} max_abs_err_vs_plain={err} (bound 0) "
        f"kernel_ms={ms:.6f} plain_ms={plain_ms:.6f} (two passes) "
        f"library_torch_add_alpha_ms={lib_ms:.6f} (max abs diff to plain "
        f"{lib_err:.3e}) bound_ms={rec['bound_ms']:.6f} (cuda events)")
    del a, o
    # the main path of this kernel: the bandwidth probe
    roofline.LAUNCHES["triad"] = 0
    bw = roofline.measure_hbm_bw(mb=1024, device=dev)
    rec["launches"] = roofline.LAUNCHES["triad"]
    if rec["launches"] == 0:
        raise AssertionError("measure_hbm_bw launched no triad kernel")
    if not 0.1 * HBM_BYTES_PER_S < bw < 1.05 * HBM_BYTES_PER_S:
        raise AssertionError(f"implausible memory rate {bw:.3e} B/s")
    log(f"triad: hbm_measured_TBps={bw / 1e12:.6f} share_of_published_peak="
        f"{bw / HBM_BYTES_PER_S:.4f} (1 GiB in + 1 GiB out per launch, "
        f"{rec['launches']} launches) phase seconds "
        f"{time.perf_counter() - t0:.1f}")
    return rec, bw


def dia_phase(dev, bw):
    """K4 at full size: the RCM-ordered Ybus, float32."""
    import torch

    from csparse3_tpu_torch import CSC, SplitDIA, SplitSymDIA
    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.linalg.ordering import rcm
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus
    from csparse3_tpu_torch.utils.roofline import pct_roofline

    t0 = time.perf_counter()
    Y0, _, _ = ybus(synthetic_grid(N_KERNEL, seed=0))
    perm = rcm(Y0)
    Yp = Y0[perm, perm]
    ip, ix, dt = Yp.np_arrays()
    Y = CSC(Yp.m, Yp.n, ip, ix, dt.astype(np.complex64))  # float32 parts
    n = Y.n
    rng = np.random.RandomState(0)
    xr, xi = rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    A = Y.to_scipy().tocsr()
    z = A.astype(np.complex128) @ (xr.astype(np.float64) + 1j * xi)
    z2 = np.stack([z.real, z.imag])
    # Row-wise rounding bound.  The plans sum, per real slab set and input
    # part, the k_i stored nonzeros of row i in float32 (the band's zeros
    # add exactly; each multiply-add rounds once or twice), then combine
    # two such sums with one more rounding.  With u = 2^-24 every version
    # is within (k_i + 2) u (|Ar| + |Ai|)(|xr| + |xi|)_i of the exact
    # product, whatever the order of the sum; k_i <= kmax.  The matrix and
    # x are float32 on both sides, so scipy's complex128 product is exact
    # to ~1e-16 of the same quantity.
    kmax = int(np.diff(A.indptr).max())
    absA = abs(A.real).astype(np.float64) + abs(A.imag).astype(np.float64)
    bound = (kmax + 2) * 2.0 ** -24 * 1.01 * (
        absA @ (np.abs(xr).astype(np.float64) + np.abs(xi)))
    bound_t = torch.as_tensor(bound, device=dev)
    xr_t, xi_t = torch.as_tensor(xr, device=dev), torch.as_tensor(xi, device=dev)
    log(f"dia: n={n} nnz={Y.nnz} max_row_nnz={kmax} host setup seconds "
        f"{time.perf_counter() - t0:.1f}")
    out = {}
    for label, make in (("dia", lambda: SplitDIA(Y, device=dev)),
                        ("symdia", lambda: SplitSymDIA(Y, tol=1e-6,
                                                       device=dev))):
        t1 = time.perf_counter()
        plan = make()
        t_build = time.perf_counter() - t1
        parts = (plan.re, plan.im)
        sym = plan.re.symmetric
        if not plan.shared_runs:
            raise AssertionError(f"{label}: the plan's slab sets share no "
                                 f"occupancy index (run shares "
                                 f"{[p.run_share for p in parts]})")
        for key in kdia.LAUNCHES:
            kdia.LAUNCHES[key] = 0
        yk = torch.stack(plan(xr_t, xi_t))
        torch.cuda.synchronize()
        if kdia.LAUNCHES != {"dia_spmv": 1, "dia_spmv_runs": 1,
                             "dia_spmv_split": 1}:
            raise AssertionError(f"{label}: launches {kdia.LAUNCHES}, not one "
                                 "walk of the shared index over 2 slab sets")
        # the plain versions: the walk of the same index, and the dense loop
        yp = torch.stack(plan.plain(xr_t, xi_t))
        yd = torch.stack(kdia.split_complex_apply(
            *(functools.partial(kdia.dia_spmv_plain, p.slabs, omin=p.omin,
                                symmetric=sym) for p in parts), xr_t, xi_t))
        # and the dense kernel on the raw slabs, as a caller without an
        # index launches it
        x2 = torch.stack([xr_t, xi_t])
        xn2 = torch.stack([xr_t, xi_t], dim=1)
        re, im = parts

        def dense_kernel():
            return [kdia.dia_spmv_cuda(p.slabs, x2, p.omin, sym)
                    for p in parts]

        vals = (re.run_values, im.run_values)

        def run_kernel():  # the launch the plan makes
            return kdia.dia_split_cuda(re.slabs, im.slabs, xn2, re.omin, sym,
                                       re.runs, vals)

        def two_launches():  # the same index, one launch per slab set
            return [kdia.dia_spmv_cuda(p.slabs, x2, p.omin, sym, p.runs,
                                       p.run_values) for p in parts]

        r2, i2 = dense_kernel()
        yraw = torch.stack([r2[0] - i2[1], r2[1] + i2[0]])
        torch.cuda.synchronize()
        if kdia.LAUNCHES != {"dia_spmv": 3, "dia_spmv_runs": 1,
                             "dia_spmv_split": 1}:
            raise AssertionError(f"{label}: a plain version launched, or the "
                                 f"dense kernel did not ({kdia.LAUNCHES})")
        r2, i2 = two_launches()
        ytwo = torch.stack([r2[0] - i2[1], r2[1] + i2[0]])
        scale = float(yd.abs().max())
        ratios = {}
        for name, got, want in (("vs_dense_plain", yk, yd),
                                ("vs_runs_plain", yk, yp),
                                ("vs_one_launch_per_slab_set", yk, ytwo),
                                ("dense_kernel_vs_dense_plain", yraw, yd)):
            ratios[name] = float(
                ((got - want).abs().double() / (2 * bound_t)).max())
        d_scipy = (yk.double() - torch.as_tensor(z2, device=dev)).abs()
        ratios["vs_scipy_c128"] = float((d_scipy / bound_t).max())
        abs_plain = float((yk - yd).abs().max())
        again = torch.stack(plan(xr_t, xi_t))
        nbytes, listed, index_bytes = run_route_bytes(plan, xn2, yk)
        dense_bytes = sum(p.slabs.numel() * p.slabs.element_size()
                          for p in parts) + 3 * yk.numel() * yk.element_size()
        log(f"{label}: diagonals_per_slab_set={plan.re.ndiag} "
            f"plan_build_s={t_build:.1f} (slabs, index and upload) "
            f"occupancy index: rows_per_group={kdia.RUN_ROWS} listed_runs="
            f"{listed} (both slab sets, one shared index) share_of_all_runs="
            f"{re.run_share:.5f} index_bytes="
            f"{index_bytes} max_abs_err_vs_dense_plain={abs_plain:.3e} (rel "
            f"to max|y| {abs_plain / scale:.3e}) worst_row_err_over_bound: "
            + " ".join(f"{k}={v:.4f}" for k, v in ratios.items())
            + f" (bound: (kmax+2) u |A||x| per row, twice that between two "
            f"float32 versions; must be <= 1) max_row_bound="
            f"{bound.max():.3e} bit_equal_on_repeat={torch.equal(again, yk)}")
        if not all(v <= 1 for v in ratios.values()):
            raise AssertionError(f"{label}: kernel disagrees")
        if not torch.equal(again, yk):
            raise AssertionError(f"{label}: two launches differ")
        for _ in range(5):
            plan(xr_t, xi_t)
        # plain, kernel, kernel, plain: one card, one call; the kernel's
        # launch alone, then the whole wrapper call (the stack of x and the
        # launch), one launch per slab set on the same index, then the dense
        # kernel and the dense plain version
        t = [queued_ms(lambda: plan.plain(xr_t, xi_t), 5),
             queued_ms(run_kernel, 200), queued_ms(run_kernel, 200),
             queued_ms(lambda: plan.plain(xr_t, xi_t), 5)]
        ms, runs_plain_ms = min(t[1], t[2]), min(t[0], t[3])
        call_ms = queued_ms(lambda: plan(xr_t, xi_t), 200)
        wall = wall_ms(lambda: plan(xr_t, xi_t), 200)
        two_ms = queued_ms(two_launches, 200)
        dense_ms = queued_ms(dense_kernel, 10)
        plain_ms = queued_ms(lambda: kdia.split_complex_apply(
            *(functools.partial(kdia.dia_spmv_plain, p.slabs, omin=p.omin,
                                symmetric=sym) for p in parts), xr_t, xi_t), 2)
        note = profiler_note(run_kernel, 20, "dia_runs_split_kernel")
        # operations: one multiply-add per stored nonzero and input row (the
        # mirror doubles the strict upper triangle's)
        nnz = sum(int(p.slabs.count_nonzero()) * 2 - int(
            p.slabs[0].count_nonzero()) if sym else int(
                p.slabs.count_nonzero()) for p in parts)
        nz_bytes, entries = nonzero_bytes(re, im, xn2, yk)
        rec = dict(abs_err=abs_plain, ms=ms, plain_ms=plain_ms,
                   runs_plain_ms=runs_plain_ms,
                   wrapper_call_ms=call_ms, two_launches_ms=two_ms,
                   dense_kernel_ms=dense_ms, listed_runs=listed,
                   index_bytes=index_bytes, bytes=nbytes,
                   nonzero_bytes=nz_bytes,
                   nonzero_bound_ms=nz_bytes / HBM_BYTES_PER_S * 1e3,
                   dense_bound_ms=dense_bytes / HBM_BYTES_PER_S * 1e3,
                   **bound_record(nbytes, 2 * 2 * nnz))
        log(f"{label}: run_kernel_device_ms_per_call={ms:.6f} (1 launch over "
            f"both slab sets) runs_plain_device_ms_per_call="
            f"{runs_plain_ms:.6f} "
            f"(cuda events around calls queued behind a spin kernel; runs "
            f"plain,kernel,kernel,plain = {t}) wrapper_device_ms_per_call="
            f"{call_ms:.6f} wrapper_wall_ms_per_call={wall:.6f} one_launch_"
            f"per_slab_set_device_ms_per_call={two_ms:.6f} "
            f"dense_kernel_on_raw_slabs_device_ms_per_call={dense_ms:.6f} "
            f"(2 launches) dense_plain_device_ms_per_call="
            f"{plain_ms:.6f}; {note}; bytes_per_call={nbytes} bound_ms="
            f"{rec['bound_ms']:.6f} ({rec['bound_by']}; the listed runs, the "
            f"index, x and y) share_of_published_peak="
            f"{pct_roofline(nbytes, ms * 1e-3, HBM_BYTES_PER_S):.4f} "
            f"share_of_measured_bandwidth="
            f"{pct_roofline(nbytes, ms * 1e-3, bw):.4f}; the nonzeros alone: "
            f"{entries} entries, nonzero_share_of_the_listed_values="
            f"{nnz / (listed * kdia.RUN_ROWS):.4f} "
            f"bytes_per_call={nz_bytes} (nonzero values, a position per "
            f"entry, x and y) nonzero_bound_ms={rec['nonzero_bound_ms']:.6f} "
            f"share_of_published_peak="
            f"{pct_roofline(nz_bytes, ms * 1e-3, HBM_BYTES_PER_S):.4f}; the "
            f"dense walk: "
            f"bytes_per_call={dense_bytes} bound_ms="
            f"{rec['dense_bound_ms']:.6f} share_of_published_peak="
            + format(pct_roofline(dense_bytes, dense_ms * 1e-3,
                                  HBM_BYTES_PER_S), ".4f"))
        out[label] = rec
        del plan, parts, re, im, vals, yk, yp, yd, yraw, ytwo, r2, i2
        del again
        torch.cuda.empty_cache()
    yk = torch.as_tensor(z2, device=dev, dtype=torch.float32)
    lib_ms = library_spmv_ms(Y, xr_t, xi_t, yk)
    log(f"dia: library_csr_c64_device_ms_per_call={lib_ms:.6f} (the same "
        f"complex product from the {Y.nnz} nonzeros instead of the "
        f"densified band) phase seconds {time.perf_counter() - t0:.1f}")
    for rec in out.values():
        rec["library_ms"] = lib_ms
    return out


def _tail_report(name, lu, dev):
    auto = lu.solve_plan(device=dev)
    level = lu.solve_plan(style="level", device=dev)
    parts = []
    for f, a, lv in (("L", auto.lplan, level.lplan),
                     ("U", auto.uplan, level.uplan)):
        tail = getattr(a, "tail", 0)
        parts.append(f"{f}: dense_tail={tail} levels={a.nlevels} "
                     f"(level-only plan: {lv.nlevels})")
    log(f"banded: solve_plan('auto') of {name} (n={lu.n}, {lu.method}, "
        f"lnz={lu.lnz}, unz={lu.unz}): " + "; ".join(parts))


def main_shape_records(dev, n, plans):
    """The DIA kernels as the banded solves launch them: float64, general or
    symmetric form, through the occupancy index the two real slab sets share.
    Holds one slab set's launch on the stacked (2, n) input, and the
    split-complex launch over both sets that the solves make, against the
    dense plain version, the plain walk of the index and scipy on the host,
    row by row; times the split-complex launch, one slab set's launch, the
    dense kernel on the raw slabs, both plain versions and the library call
    (a complex128 torch.sparse CSR matrix times the complex x).  ``plans``
    maps a label to (complex Ybus, its split plan); returns a record for each
    label."""
    import scipy.sparse as sp
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia

    x2 = torch.rand((2, n), dtype=torch.float64, device=dev)
    x2h = x2.cpu().numpy()
    out = {}
    for label, (Y, plan) in plans.items():
        sym = plan.re.symmetric
        A = Y.to_scipy().tocsr()
        if sym:
            # what the symmetric plan holds: the upper triangle and its
            # mirror (the plan admitted the matrix as symmetric to 1e-12)
            A = (sp.triu(A) + sp.triu(A, 1).T).tocsr()
        # Row-wise rounding bound, as in the float32 phase with u = 2^-53:
        # every version (kernel, plain, scipy's float64 product) sums the
        # k_i <= kmax stored nonzeros of row i with one or two roundings
        # each, so it lies within (kmax + 2) u (|A| |x|)_i of the exact
        # product and two versions within twice that
        kmax = int(np.diff(A.indptr).max())
        rec = dict(abs_err=0.0)
        for part in ("re", "im"):
            Ap = getattr(A, "real" if part == "re" else "imag").tocsr()
            p = getattr(plan, part)
            if not p.has_runs:
                raise AssertionError(f"{label}.{part}: no occupancy index "
                                     f"(run share {p.run_share})")
            bound = torch.as_tensor(
                2 * (kmax + 2) * 2.0 ** -53 * 1.01 * (abs(Ap) @ x2h.T).T,
                device=dev)
            before = dict(kdia.LAUNCHES)
            yk = kdia.dia_spmv_cuda(p.slabs, x2, p.omin, sym, p.runs,
                                    p.run_values)
            torch.cuda.synchronize()
            if (kdia.LAUNCHES["dia_spmv"] != before["dia_spmv"] + 1
                    or kdia.LAUNCHES["dia_spmv_runs"]
                    != before["dia_spmv_runs"] + 1):
                raise AssertionError(f"{label}.{part}: not one launch "
                                     "through the index")
            yraw = kdia.dia_spmv_cuda(p.slabs, x2, p.omin, sym)
            yp = kdia.dia_spmv_plain(p.slabs, x2, p.omin, sym)
            yw = kdia.dia_spmv_runs_plain(p.slabs, x2, p.omin, sym, p.runs)
            ys = torch.as_tensor((Ap @ x2h.T).T, device=dev)
            tiny = torch.finfo(torch.float64).tiny
            ratios = {name: float(((got - want).abs() / (bound + tiny)).max())
                      for name, got, want in (
                          ("vs_dense_plain", yk, yp),
                          ("vs_runs_plain", yk, yw),
                          ("vs_scipy_f64", yk, ys),
                          ("dense_kernel_vs_dense_plain", yraw, yp))}
            err = float((yk - yp).abs().max())
            rec["abs_err"] = max(rec["abs_err"], err)
            again = kdia.dia_spmv_cuda(p.slabs, x2, p.omin, sym, p.runs,
                                       p.run_values)
            log(f"banded: dia kernel[{label}.{part}] float64 slabs="
                f"{tuple(p.slabs.shape)} x=(2, {n}) listed_runs="
                f"{sum(t.numel() for t in p.runs[1::2])} share_of_all_runs="
                f"{p.run_share:.5f} max_abs_err_vs_dense_plain={err:.3e} "
                f"worst_row_err_over_bound: "
                + " ".join(f"{k}={v:.4f}" for k, v in ratios.items())
                + f" (bound: 2 (kmax+2) 2^-53 |A||x| per row, kmax={kmax}; "
                f"must be <= 1) max_row_bound={float(bound.max()):.3e} "
                f"bit_equal_on_repeat={torch.equal(again, yk)}")
            if not all(v <= 1 for v in ratios.values()):
                raise AssertionError(f"{label}.{part}: kernel disagrees at "
                                     "the main path's shape")
            if not torch.equal(again, yk) or not torch.equal(
                    p.apply_bn(x2), yk):
                raise AssertionError(f"{label}.{part}: two launches differ")
        # ---- the launch the solves make: one walk of the shared index over
        # both slab sets, x as (n, 2), on the packed run values.  Bit-equal on
        # repeat; within the rounding bound of one launch per slab set, the
        # plain versions and scipy
        if not plan.shared_runs:
            raise AssertionError(f"{label}: the slab sets share no index")
        re, im = plan.re, plan.im
        omin, runs = re.omin, re.runs
        xn2 = x2.T.contiguous()
        before = dict(kdia.LAUNCHES)
        yk = torch.stack(plan(x2[0], x2[1]))
        torch.cuda.synchronize()
        if any(kdia.LAUNCHES[k] != before[k] + 1 for k in before):
            raise AssertionError(f"{label}: not one launch over both slab "
                                 f"sets ({before} -> {kdia.LAUNCHES})")
        two = torch.stack(kdia.split_complex_apply(
            re.apply_bn, im.apply_bn, x2[0], x2[1]))
        dense = functools.partial(
            kdia.split_complex_apply,
            *(functools.partial(kdia.dia_spmv_plain, p.slabs, omin=omin,
                                symmetric=sym) for p in (re, im)),
            x2[0], x2[1])
        yd = torch.stack(dense())
        yw = torch.stack(plan.plain(x2[0], x2[1]))
        z = A @ (x2h[0] + 1j * x2h[1])
        cbound = torch.as_tensor(
            2 * (kmax + 2) * 2.0 ** -53 * 1.01 * (
                (abs(A.real) + abs(A.imag)) @ np.abs(x2h).sum(0)), device=dev)
        ratios = {name: float(((yk - want).abs() / (cbound + tiny)).max())
                  for name, want in (
                      ("vs_dense_plain", yd), ("vs_runs_plain", yw),
                      ("vs_one_launch_per_slab_set", two),
                      ("vs_scipy_c128", torch.as_tensor(
                          np.stack([z.real, z.imag]), device=dev)))}
        split_err = float((yk - yd).abs().max())
        rec["abs_err"] = max(rec["abs_err"], split_err)
        vals = (re.run_values, im.run_values)
        same = torch.equal(
            kdia.dia_split_cuda(re.slabs, im.slabs, xn2, omin, sym, runs,
                                vals),
            yk) and torch.equal(torch.stack(plan(x2[0], x2[1])), yk)
        log(f"banded: dia kernel[{label}] split-complex launch float64 x=("
            f"{n}, 2) max_abs_err_vs_dense_plain={split_err:.3e} "
            f"worst_row_err_over_bound: "
            + " ".join(f"{k}={v:.4f}" for k, v in ratios.items())
            + f" (must be <= 1) bit_equal_on_repeat={same}")
        if not all(v <= 1 for v in ratios.values()) or not same:
            raise AssertionError(f"{label}: the split-complex launch "
                                 "disagrees at the main path's shape")

        def run_kernel():
            return kdia.dia_split_cuda(re.slabs, im.slabs, xn2, omin, sym,
                                       runs, vals)

        def one_set():
            return kdia.dia_spmv_cuda(re.slabs, x2, omin, sym, runs, vals[0])

        def runs_plain():
            return plan.plain(x2[0], x2[1])

        def dense_kernel():
            return [kdia.dia_spmv_cuda(p.slabs, x2, omin, sym)
                    for p in (re, im)]

        for _ in range(10):
            run_kernel()
        # plain, kernel, kernel, plain: one card, one call
        t = [queued_ms(runs_plain, 20), queued_ms(run_kernel, 400),
             queued_ms(run_kernel, 400), queued_ms(runs_plain, 20)]
        ms, runs_plain_ms = min(t[1], t[2]), min(t[0], t[3])
        ev = cuda_ms(lambda: plan(x2[0], x2[1]), 200)
        one_ms = queued_ms(one_set, 400)
        dense_ms = queued_ms(dense_kernel, 100)
        plain_ms = queued_ms(dense, 3)
        # the library call: the complex128 CSR matrix times the complex x
        lib = _csr_tensor(A, dev, np.complex128)
        xc = torch.complex(x2[0], x2[1])
        yl = lib @ xc
        if float((torch.stack([yl.real, yl.imag]) - yk).abs().max()) \
                > 1e-12 * float(yk.abs().max()):
            raise AssertionError(f"{label}: library CSR product disagrees")
        for _ in range(10):
            lib @ xc
        _, lbusy, _, _ = device_profile(lambda: lib @ xc, 50)
        lib_ms = lbusy / 50 * 1e3
        nbytes, listed, index_bytes = run_route_bytes(plan, xn2, yk)
        dense_bytes = (2 * re.slabs.numel() + x2.numel() + yk.numel()) * 8
        nnz = sum(int(p.slabs.count_nonzero()) * 2 - int(
            p.slabs[0].count_nonzero()) if sym else int(
                p.slabs.count_nonzero()) for p in (re, im))
        nz_bytes, entries = nonzero_bytes(re, im, xn2, yk)
        rec.update(ms=ms, plain_ms=plain_ms, runs_plain_ms=runs_plain_ms,
                   library_ms=lib_ms, one_slab_set_ms=one_ms,
                   dense_kernel_ms=dense_ms, listed_runs=listed,
                   index_bytes=index_bytes, bytes=nbytes,
                   nonzero_bytes=nz_bytes,
                   nonzero_bound_ms=nz_bytes / HBM_BYTES_PER_S * 1e3,
                   dense_bound_ms=dense_bytes / HBM_BYTES_PER_S * 1e3,
                   **bound_record(nbytes, 2 * 2 * nnz, F64_FLOP_PER_S))
        log(f"banded: dia kernel[{label}] at this path's shape (float64, "
            f"D={re.slabs.shape[0]}, n={n}, both slab sets in one launch): "
            f"run_kernel_device_ms_per_launch={ms:.6f} runs_plain_device_ms="
            f"{runs_plain_ms:.6f} (cuda events around launches queued behind a "
            f"spin kernel; runs plain,kernel,kernel,plain = {t}); the plan's "
            f"call with the host in the way {ev:.6f} ms; one_slab_set_x(2, n)_"
            f"run_kernel_device_ms={one_ms:.6f} dense_kernel_on_raw_"
            f"slabs_device_ms={dense_ms:.6f} (2 launches) "
            f"dense_plain_device_ms="
            f"{plain_ms:.6f} library_csr_c128_device_ms={lib_ms:.6f} "
            f"(torch.profiler); {nbytes} bytes per launch ({listed} listed "
            f"runs over both sets, index {index_bytes} bytes) bound_ms="
            f"{rec['bound_ms']:.6f} ({rec['bound_by']}); the nonzeros alone "
            f"({entries} entries: values, a position each, x and y): "
            f"{nz_bytes} bytes, nonzero_bound_ms="
            f"{rec['nonzero_bound_ms']:.6f}; the dense walk: "
            f"{dense_bytes} bytes, bound_ms={rec['dense_bound_ms']:.6f}")
        out[label] = rec
    return out


def banded_phase(dev, ell_state):
    """The banded power flow at 10k buses, RCM order: Newton on the DIA
    kernel, fast-decoupled on the symmetric and the general DIA kernel, DC
    flow.  Returns the DIA kernel's launches over the three solves and its
    records at this path's shape."""
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.models.grids import SLACK, rcm_grid, synthetic_grid
    from csparse3_tpu_torch.models.powerflow import (
        FastDecoupled, NewtonPowerFlow, _b_series, dc_power_flow)

    t0 = time.perf_counter()
    g, perm = rcm_grid(synthetic_grid(N_SOLVE, seed=3))
    t1 = time.perf_counter()
    pf = NewtonPowerFlow(g, spmv="dia", device=dev)
    t_build = time.perf_counter() - t1
    fds = {}
    for sp in ("symdia", "dia"):
        t1 = time.perf_counter()
        fds[sp] = FastDecoupled(g, spmv=sp, device=dev)
        log(f"banded: FastDecoupled[{sp}] build_s="
            f"{time.perf_counter() - t1:.3f}")
    _tail_report("B'", fds["dia"].lu_bp, dev)
    _tail_report("B''", fds["dia"].lu_bpp, dev)
    for sp in fds:  # warm the solve paths (first-use allocations)
        fds[sp].solve()

    # ---- the main path: counts to 0, the three solves, counts read
    for key in kdia.LAUNCHES:
        kdia.LAUNCHES[key] = 0
    t1 = time.perf_counter()
    vm, va, it, res = pf.solve()
    torch.cuda.synchronize()
    t_newton = time.perf_counter() - t1
    n_newton = kdia.LAUNCHES["dia_spmv"]
    fd_out = {}
    for sp, fd in fds.items():
        before = kdia.LAUNCHES["dia_spmv"]
        t1 = time.perf_counter()
        r = fd.solve()
        torch.cuda.synchronize()
        fd_out[sp] = r + (time.perf_counter() - t1,
                          kdia.LAUNCHES["dia_spmv"] - before)
    launches = kdia.LAUNCHES["dia_spmv"]
    if kdia.LAUNCHES["dia_spmv_split"] != launches:
        raise AssertionError(
            f"banded: {kdia.LAUNCHES['dia_spmv_split']} of {launches} "
            "launches walked a shared occupancy index over both slab sets; "
            "the solvers' plans all have one")

    hm = host_mismatch(g, pf.Y, vm, va)
    vm_e, va_e = ell_state
    diff = max(np.abs(vm - vm_e[perm]).max(), np.abs(va - va_e[perm]).max())
    D = pf._yplan.re.ndiag
    log(f"banded: newton[dia] buses={g.n_bus} diagonals={D} iterations={it} "
        f"residual={res:.3e} host_f64_mismatch={hm:.3e} (bound "
        f"{DIA_HOST_MISMATCH:.0e}) kernel_launches={n_newton} "
        f"build_s={t_build:.3f} solve_s={t_newton:.4f} "
        f"max_state_diff_vs_ell_of_natural_order={diff:.3e} (bound "
        f"{DIA_STATE_ATOL:.0e})")
    if not res <= pf.tol or it >= pf.max_iter:
        raise AssertionError(f"newton[dia]: did not converge ({it}, {res})")
    if hm > DIA_HOST_MISMATCH or diff > DIA_STATE_ATOL:
        raise AssertionError("newton[dia]: wrong state")
    # one launch over both real slab sets per mismatch evaluation
    if n_newton == 0 or n_newton != it + 1:
        raise AssertionError(f"newton[dia]: {n_newton} launches for "
                             f"{it + 1} mismatch evaluations")
    for sp, (vm_f, va_f, it_f, res_f, sec, nl) in fd_out.items():
        fd = fds[sp]
        diff = max(np.abs(vm_f - vm).max(), np.abs(va_f - va).max())
        log(f"banded: fdpf[{sp}] iterations={it_f} residual={res_f:.3e} "
            f"kernel_launches={nl} solve_s={sec:.4f} "
            f"max_state_diff_vs_newton={diff:.3e} (bound "
            f"{FDPF_STATE_ATOL:.0e})")
        if not res_f <= fd.tol or it_f >= fd.max_iter:
            raise AssertionError(f"fdpf[{sp}]: did not converge")
        if diff > FDPF_STATE_ATOL:
            raise AssertionError(f"fdpf[{sp}]: disagrees with Newton")
        # per iteration one residual and two half-step mismatches, then the
        # residual that ends the loop and the one solve() reports; each is
        # one launch over both real slab sets
        if nl == 0 or nl != 3 * it_f + 2:
            raise AssertionError(f"fdpf[{sp}]: {nl} launches for {it_f} "
                                 "iterations")
    wall, busy, nk, by = device_profile(fds["symdia"].solve, 1)
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"banded: fdpf[symdia] profiled solve wall_s={wall:.4f} "
        f"device_busy_s={busy:.4f} idle_share={1 - busy / wall:.4f} "
        f"kernels={nk} top_by_device_s=" + "; ".join(
            f"{k[:60]} x{c} {s:.4f}" for k, (c, s) in top))
    recs = main_shape_records(
        dev, g.n_bus, {"dia": (pf.Y, pf._yplan),
                       "symdia": (fds["symdia"].Y, fds["symdia"]._yplan)})

    t1 = time.perf_counter()
    th = dc_power_flow(g, device=dev)
    torch.cuda.synchronize()
    t_dc = time.perf_counter() - t1
    keep = np.flatnonzero(g.bus_type != SLACK)
    ref = np.zeros(g.n_bus)
    ref[keep] = spla.spsolve(_b_series(g)[keep, keep].to_scipy().tocsc(),
                             (g.pg - g.pd)[keep])
    err = np.abs(th - ref).max() / np.abs(ref).max()
    log(f"banded: dc_power_flow seconds={t_dc:.3f} (host factor included) "
        f"max_rel_err_vs_scipy_spsolve={err:.3e} (bound {DC_RTOL:.0e})")
    if not err <= DC_RTOL:
        raise AssertionError("dc_power_flow disagrees with scipy")
    log(f"banded: phase seconds {time.perf_counter() - t0:.1f}")
    return launches, recs


def _csr_tensor(S, dev, dtype):
    """A scipy matrix as a torch.sparse CSR tensor on the card (for the
    library calls timed beside the kernels; used nowhere in the port)."""
    import torch

    S = S.tocsr()
    return torch.sparse_csr_tensor(
        torch.as_tensor(S.indptr.astype(np.int64), device=dev),
        torch.as_tensor(S.indices.astype(np.int64), device=dev),
        torch.as_tensor(S.data.astype(dtype), device=dev), size=S.shape)


def spgemm_phase(dev):
    """K6 and the sparse-product path around it.  Returns (launches on the
    main path, {case: record})."""
    import scipy.sparse as sp
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.kernels import spgemm as kspg
    from csparse3_tpu_torch.models.grids import connectivity, synthetic_grid

    t_phase = time.perf_counter()
    u32 = 2.0 ** -24

    def conn(n, seed):
        Cf, Ct = connectivity(synthetic_grid(n, seed=seed))
        return Cf - Ct

    def rand10k():
        return pt.CSC.from_scipy(sp.random(
            10_000, 10_000, density=1e-3, format="csc",
            random_state=np.random.RandomState(0)))

    # ---- host: the eager products against scipy, the symbolic phases
    cases = {}
    for label, make in (("conn3000", lambda: conn(3000, 1)),
                        ("rand10k", rand10k),
                        ("conn200k", lambda: conn(N_KERNEL, 0))):
        t0 = time.perf_counter()
        A = make()
        B = A.T
        S = A.to_scipy()
        ref = (S @ S.T).tocsc()
        ref.sort_indices()
        t1 = time.perf_counter()
        G = pt.gram(A)               # fused native kernel, symbolic cached
        t_gram = time.perf_counter() - t1
        t1 = time.perf_counter()
        G2 = pt.gram(A)              # numeric pass alone
        t_regram = time.perf_counter() - t1
        H = A @ B                    # general native SpGEMM
        scale = np.abs(ref.data).max()
        for name, got in (("gram", G), ("gram revalue", G2), ("A @ A.T", H)):
            ip, ix, dt = got.np_arrays()
            if not (np.array_equal(ip, ref.indptr)
                    and np.array_equal(ix, ref.indices)):
                raise AssertionError(f"spgemm[{label}]: pattern of {name} "
                                     "differs from scipy's")
            if np.abs(dt - ref.data).max() > 1e-12 * scale:
                raise AssertionError(f"spgemm[{label}]: {name} disagrees "
                                     "with scipy")
        if label == "rand10k":  # the add and transpose config 2 bundles
            got = pt.add(G, A).t().to_scipy()
            want = ((S @ S.T) + S).T.tocsc()
            if abs(got - want).max() > 1e-12 * scale:
                raise AssertionError("spgemm[rand10k]: add(gram(A), A).t() "
                                     "disagrees with scipy")
        t1 = time.perf_counter()
        plan = pt.spgemm_symbolic(A, B, device=dev)
        t_sym = time.perf_counter() - t1
        t1 = time.perf_counter()
        gplan = pt.gram_symbolic(A, device=dev)
        t_gsym = time.perf_counter() - t1
        a32 = A.np_arrays()[2].astype(np.float32)
        b32 = B.np_arrays()[2].astype(np.float32)
        cases[label] = dict(
            A=A, B=B, ref=ref, plan=plan, gplan=gplan,
            a32=torch.as_tensor(a32, device=dev),
            b32=torch.as_tensor(b32, device=dev))
        log(f"spgemm[{label}]: A {A.shape} nnz={A.nnz} products="
            f"{plan.n_products} outputs={plan.out_nnz} longest_segment="
            f"{int(plan.seg_ptr.diff().max())} gram_plan_products="
            f"{gplan.n_products} host seconds: gram={t_gram:.3f} "
            f"gram_revalue={t_regram:.3f} spgemm_symbolic={t_sym:.3f} "
            f"gram_symbolic={t_gsym:.3f} (symbolic: once per pattern, upload "
            f"included) setup_and_scipy={time.perf_counter() - t0:.1f}")
        if not (np.array_equal(plan.template.np_arrays()[0], ref.indptr)
                and np.array_equal(plan.template.np_arrays()[1], ref.indices)
                and np.array_equal(gplan.template.np_arrays()[1],
                                   ref.indices)):
            raise AssertionError(f"spgemm[{label}]: symbolic pattern differs "
                                 "from scipy's")

    # ---- the main path: counts to 0, the numeric passes, counts read
    kspg.LAUNCHES["spgemm_numeric"] = 0
    for c in cases.values():
        c["C"] = c["plan"].numeric(c["a32"], c["b32"])
        c["Cg"] = c["gplan"].numeric(c["a32"])
    torch.cuda.synchronize()
    launches = kspg.LAUNCHES["spgemm_numeric"]
    if launches != 2 * len(cases):
        raise AssertionError(f"spgemm: {launches} launches for "
                             f"{2 * len(cases)} numeric calls")

    # ---- the launch floor: the kernel on a plan of one output
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    ptr1 = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    v1 = torch.ones(1, device=dev)
    if float(kspg.spgemm_numeric_cuda(ptr1, one, one, v1, 2 * v1)[0]) != 2:
        raise AssertionError("spgemm: the one-output plan disagrees")
    floor_ms = min(queued_ms(lambda: kspg.spgemm_numeric_cuda(
        ptr1, one, one, v1, v1), 400) for _ in range(2))
    log(f"spgemm: launch_floor_ms={floor_ms:.6f} (the kernel on a plan of "
        f"one output, queued behind a spin kernel)")

    # ---- checks and times
    out = {}
    for label, c in cases.items():
        plan, a32, b32, ref = c["plan"], c["a32"], c["b32"], c["ref"]
        n_out = plan.out_nnz
        before = kspg.LAUNCHES["spgemm_numeric"]
        plain = kspg.spgemm_numeric_plain(plan.gid, plan.pa_s, plan.pb_s,
                                          a32, b32, n_out)
        if kspg.LAUNCHES["spgemm_numeric"] != before:
            raise AssertionError("spgemm: the plain version launched")
        # Rounding bound per output.  The values are float32 on every side
        # and scipy sums their exact products in float64.  The kernel and
        # the plain version round each of the L products of an output and
        # each partial sum once: within (L + 1) u sum|a||b| of the exact
        # sum whatever the order, two float32 versions within twice that.
        # sum|a||b| is |A| @ |A|.T, which has the pattern of A @ A.T.
        S32 = abs(c["A"].to_scipy().astype(np.float32).astype(np.float64))
        absum = (S32 @ S32.T).tocsc()
        absum.sort_indices()
        Sv = c["A"].to_scipy().astype(np.float32).astype(np.float64)
        ref32 = (Sv @ Sv.T).tocsc()
        ref32.sort_indices()
        L = plan.seg_ptr.diff().double()
        bound = (L + 1) * u32 * 1.01 * torch.as_tensor(absum.data, device=dev)
        tiny = torch.finfo(torch.float64).tiny
        data = c["C"].data
        d_plain = (data - plain).abs().double()
        d_scipy = (data.double() - torch.as_tensor(ref32.data,
                                                   device=dev)).abs()
        r_plain = float((d_plain / (2 * bound + tiny)).max())
        r_scipy = float((d_scipy / (bound + tiny)).max())
        abs_plain = float(d_plain.max())
        # the symmetric plan, the device ESC product, float64 through the
        # same kernel: all on scipy's pattern
        d_gram = float((c["Cg"].data.double() - torch.as_tensor(
            ref32.data, device=dev)).abs().div(bound + tiny).max())
        D = pt.spgemm_device(c["A"], c["B"], device=dev)
        C64 = plan.numeric(c["A"].np_arrays()[2], c["B"].np_arrays()[2])
        scale = np.abs(ref.data).max()
        for name, got in (("spgemm_device", D), ("float64 numeric", C64)):
            ip, ix, dt = got.np_arrays()
            if not (np.array_equal(ix, ref.indices)
                    and np.abs(dt - ref.data).max() <= 1e-12 * scale):
                raise AssertionError(f"spgemm[{label}]: {name} disagrees "
                                     "with scipy")
        log(f"spgemm[{label}]: max_abs_err_vs_plain={abs_plain:.3e} "
            f"worst_output_err_over_bound: vs_plain={r_plain:.4f} "
            f"vs_scipy_f64={r_scipy:.4f} gram_plan_vs_scipy_f64={d_gram:.4f} "
            f"(bound: (L+1) 2^-24 sum|a||b| per output, twice that between "
            f"two float32 versions; must be <= 1) spgemm_device and the "
            f"float64 numeric pass agree with scipy to 1e-12")
        if not (r_plain <= 1 and r_scipy <= 1 and d_gram <= 1):
            raise AssertionError(f"spgemm[{label}]: kernel disagrees")

        def kernel():
            return kspg.spgemm_numeric_cuda(plan.seg_ptr, plan.pa_s,
                                            plan.pb_s, a32, b32)

        def plain_fn():
            return kspg.spgemm_numeric_plain(plan.gid, plan.pa_s, plan.pb_s,
                                             a32, b32, n_out)

        for _ in range(10):
            kernel()
            plain_fn()
        # plain, kernel, kernel, plain: one card, one call
        t = [queued_ms(plain_fn, 50), queued_ms(kernel, 200),
             queued_ms(kernel, 200), queued_ms(plain_fn, 50)]
        ms, plain_ms = min(t[1], t[2]), min(t[0], t[3])
        ev = [cuda_ms(plain_fn, 50), cuda_ms(kernel, 200)]
        note = profiler_note(kernel, 50, "spgemm_numeric_kernel")
        # what the kernel reads (the three maps, both value arrays) and
        # writes (data), each once; one multiply-add per product.  The
        # least any layout needs: the two maps, the values, the output and
        # one bit per product for the segment boundaries
        nbytes = sum(x.numel() * x.element_size() for x in (
            plan.seg_ptr, plan.pa_s, plan.pb_s, a32, b32, data))
        least = nbytes - plan.seg_ptr.numel() * 4 + -(-plan.n_products // 8)
        rec = dict(abs_err=abs_plain, ms=ms, plain_ms=plain_ms,
                   products=plan.n_products, outputs=n_out,
                   outputs_per_thread=kspg.outputs_per_thread(n_out),
                   least_bytes=least,
                   least_bytes_bound_ms=least / HBM_BYTES_PER_S * 1e3,
                   launch_floor_ms=floor_ms,
                   **bound_record(nbytes, 2 * plan.n_products))
        # the device ESC product (expand, sort, compress per call): its
        # bincount reads the output size back, so the queued time holds
        # the host's gap after that read
        esc = pt.ESCSpGEMM(c["A"], c["B"], device=dev)
        esc(a32, b32)
        rec["esc_wall_ms"] = wall_ms(lambda: esc(a32, b32), 5)
        rec["esc_queued_ms"] = queued_ms(lambda: esc(a32, b32), 5)
        del esc
        # the library call: symbolic and numeric phase together
        try:
            La = _csr_tensor(c["A"].to_scipy(), dev, np.float32)
            Lb = _csr_tensor(c["B"].to_scipy(), dev, np.float32)
            Lc = torch.sparse.mm(La, Lb)
            lib_sum = float(Lc.values().double().sum())
            if Lc._nnz() != n_out or abs(
                    lib_sum - ref32.data.sum()) > 1e-5 * absum.data.sum():
                raise AssertionError(f"spgemm[{label}]: library product "
                                     f"disagrees ({Lc._nnz()} nonzeros)")
            for _ in range(3):
                torch.sparse.mm(La, Lb)
            # it waits for the device inside (the output size), so plain
            # events around back-to-back calls time it whole
            rec["library_ms"] = cuda_ms(lambda: torch.sparse.mm(La, Lb), 10)
            lib_note = (f"library_torch_sparse_mm_csr_f32_ms_per_call="
                        f"{rec['library_ms']:.6f} (symbolic and numeric "
                        f"together, cuda events over 10 calls)")
            del La, Lb, Lc
        except RuntimeError as e:
            rec["library_ms"] = None
            lib_note = ("library: this torch build refuses torch.sparse.mm "
                        f"of two CSR tensors ({str(e)[:80]})")
        log(f"spgemm[{label}]: kernel_device_ms_per_launch={ms:.6f} "
            f"plain_device_ms_per_call={plain_ms:.6f} (cuda events around "
            f"launches queued behind a spin kernel; runs plain,kernel,"
            f"kernel,plain = {t}); with the host in the way: plain "
            f"{ev[0]:.6f} kernel {ev[1]:.6f} ms per call; {note}; "
            f"bytes_per_launch={nbytes} bound_ms={rec['bound_ms']:.6f} "
            f"({rec['bound_by']}) least_bytes={least} least_bytes_bound_ms="
            f"{rec['least_bytes_bound_ms']:.6f} launch_floor_ms="
            f"{floor_ms:.6f} outputs_per_thread={rec['outputs_per_thread']} "
            f"share_of_bound={rec['bound_ms'] / ms:.4f} {lib_note}; "
            f"ESCSpGEMM wall_ms_per_call={rec['esc_wall_ms']:.6f} "
            f"queued_ms_per_call={rec['esc_queued_ms']:.6f} (5 calls)")
        out[label] = rec
    # where the time goes on this path: the entry point, host included
    big = cases["conn200k"]

    def numeric():
        return big["plan"].numeric(big["a32"], big["b32"])

    wall, busy = wall_ms(numeric, 200), queued_ms(numeric, 200)
    log(f"spgemm[conn200k]: plan.numeric wall_ms_per_call={wall:.6f} "
        f"device_ms_per_call={busy:.6f} idle_share={1 - busy / wall:.4f} "
        f"(200 calls, host clock against queued device time)")
    del cases
    torch.cuda.empty_cache()
    log(f"spgemm: phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, out


def _bsr_row_bound(S, X, dev):
    """(scipy float64 product, row-wise rounding bound, K) of Y = S @ X on
    the card.  Row i sums its K_i <= K stored nonzeros in float32 (the
    blocks' zeros add exactly): every version lies within (K + 2) u
    (|A| |X|)_i of the exact product."""
    import torch

    K = int(np.diff(S.tocsr().indptr).max())
    X64 = X.astype(np.float64)
    ref = torch.as_tensor(S @ X64, device=dev)
    bound = torch.as_tensor(
        (K + 2) * 2.0 ** -24 * 1.01 * (abs(S) @ np.abs(X64)), device=dev)
    return ref, bound, K


def _bsr_row_check(label, Y, Yp, rows):
    """Hold Y (kernel) against scipy float64 within the bound of
    ``_bsr_row_bound`` (``rows``), and against Yp (a plain version: two
    float32 versions) within twice that.  Returns max|Y - Yp|."""
    import torch

    ref, bound, K = rows
    tiny = torch.finfo(torch.float64).tiny
    d_plain = (Y - Yp).abs().double()
    r_plain = float((d_plain / (2 * bound + tiny)).max())
    r_scipy = float(((Y.double() - ref).abs() / (bound + tiny)).max())
    err = float(d_plain.max())
    log(f"bsr[{label}]: max_abs_err_vs_plain={err:.3e} (max|Y| "
        f"{float(Y.abs().max()):.3e}) worst_row_err_over_bound: vs_plain="
        f"{r_plain:.4f} vs_scipy_f64={r_scipy:.4f} (bound: (K+2) 2^-24 "
        f"|A||X| per row, K={K}, twice that between two float32 versions; "
        f"must be <= 1)")
    if not (r_plain <= 1 and r_scipy <= 1):
        raise AssertionError(f"bsr[{label}]: kernel disagrees")
    return err


def bsr_phase(dev):
    """K5 and the BSR path around it.  Returns (launches on the main path,
    {case: record})."""
    import scipy.sparse as sp
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.kernels import bsr_spmm as kbsr
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus

    t_phase = time.perf_counter()
    K_RHS = 1024  # right-hand sides, as BASELINE configs 3-4

    # ---- host set-up.  (a) the block matrix of the JAX bench
    Rb, nb_rows, bpr = 32, 512, 6
    n_a = nb_rows * Rb
    rng = np.random.RandomState(0)
    rowsb = np.repeat(np.arange(nb_rows), bpr)
    colsb = rng.randint(0, nb_rows, nb_rows * bpr)
    key = np.unique(rowsb * nb_rows + colsb)
    rowsb, colsb = key // nb_rows, key % nb_rows
    data_a = rng.rand(len(rowsb), Rb, Rb).astype(np.float32)
    indptr_a = np.searchsorted(rowsb, np.arange(nb_rows + 1))
    S_a = sp.bsr_matrix((data_a.astype(np.float64), colsb, indptr_a),
                        shape=(n_a, n_a))
    A = pt.BSR(n_a, n_a, Rb, Rb, indptr_a, colsb, data_a, device=dev)
    X_a = rng.rand(n_a, K_RHS).astype(np.float32)
    # (b) the susceptance matrix of the 200k-bus grid, float32, natural
    # bus order: 145,581 blocks of (8, 128), 0.6 GB (RCM order would give
    # 207,169), so no reordering is needed to stay under 10 GB
    t0 = time.perf_counter()
    Yb, _, _ = ybus(synthetic_grid(N_KERNEL, seed=0))
    ip, ix, dt = Yb.np_arrays()
    Bm = pt.CSC(Yb.m, Yb.n, ip, ix,
                np.ascontiguousarray(dt.imag).astype(np.float32), device=dev)
    S_b = Bm.to_scipy().astype(np.float64).tocsr()
    X_b = np.random.RandomState(1).rand(Bm.n, K_RHS).astype(np.float32)
    t1 = time.perf_counter()
    bsr_b = Bm.to_bsr(block=(8, 128))
    t_pack = time.perf_counter() - t1
    nblk_b = bsr_b.nnz_blocks
    log(f"bsr: (a) {n_a}^2, {len(rowsb)} blocks of {Rb}x{Rb}, X ({n_a}, "
        f"{K_RHS}); (b) imag(Ybus) {Bm.shape} nnz={Bm.nnz} float32, block "
        f"(8, 128): {nblk_b} blocks = {nblk_b * 8 * 128 * 4 / 1e9:.3f} GB "
        f"(natural order), X ({Bm.n}, {K_RHS}); host csc_to_bsr seconds "
        f"{t_pack:.2f}, set-up seconds {time.perf_counter() - t0:.1f}")
    Bm._bsr_cache = bsr_b  # what spmm would pack at its first call
    Xa_t = torch.as_tensor(X_a, device=dev)
    Xb_t = torch.as_tensor(X_b, device=dev)
    # warm: the block stacks are uploaded here, not in the main path
    A @ Xa_t
    pt.spmm(Bm, Xb_t, block=(8, 128))

    # ---- the main path: counts to 0, the two products, counts read
    kbsr.LAUNCHES["bsr_spmm"] = 0
    Y_a = A @ Xa_t
    Y_b = pt.spmm(Bm, Xb_t, block=(8, 128))
    torch.cuda.synchronize()
    launches = kbsr.LAUNCHES["bsr_spmm"]
    if launches != 2:
        raise AssertionError(f"bsr: {launches} launches for 2 products")

    out = {}
    placed = Bm._bsr_cache
    for label, M, S, X, Xt, Y, reps in (
            ("block32", A, S_a, X_a, Xa_t, Y_a, 50),
            ("ybus200k", placed, S_b, X_b, Xb_t, Y_b, 20)):
        nblk = M.nnz_blocks
        args = (M.m, M.n, M.indptr, M.indices[:nblk], M.data[:nblk], Xt)
        cols = M.column_lists()  # built at the container's first product
        listed = cols[1].numel()
        before = kbsr.LAUNCHES["bsr_spmm"]
        Yp = kbsr.bsr_spmm_plain(*args)
        if kbsr.LAUNCHES["bsr_spmm"] != before:
            raise AssertionError("bsr: the plain version launched")
        rows = _bsr_row_bound(S, X, dev)
        err = _bsr_row_check(label, Y, Yp, rows)
        # the plain walk of the same lists, and the kernel without lists
        # (every column of every block, as a raw caller launches it)
        Yw = kbsr.bsr_spmm_plain(*args, cols)
        _bsr_row_check(f"{label}, kernel vs the plain walk of the lists", Y,
                       Yw, rows)
        del Yw
        Yraw = kbsr.bsr_spmm_cuda(*args)
        _bsr_row_check(f"{label}, kernel without lists", Yraw, Yp, rows)
        del Yp, Yraw, rows
        again = kbsr.bsr_spmm_cuda(*args, cols)
        if not (torch.equal(again, Y)
                and torch.equal(kbsr.bsr_spmm_cuda(*args, cols), again)):
            raise AssertionError(f"bsr[{label}]: two launches differ")
        del again
        # plain, kernel, kernel, plain: one card, one call
        t = [queued_ms(lambda: kbsr.bsr_spmm_plain(*args, cols), 2),
             queued_ms(lambda: kbsr.bsr_spmm_cuda(*args, cols), reps),
             queued_ms(lambda: kbsr.bsr_spmm_cuda(*args, cols), reps),
             queued_ms(lambda: kbsr.bsr_spmm_plain(*args, cols), 2)]
        ms, lists_plain_ms = min(t[1], t[2]), min(t[0], t[3])
        raw_ms = queued_ms(lambda: kbsr.bsr_spmm_cuda(*args), 5)
        plain_ms = queued_ms(lambda: kbsr.bsr_spmm_plain(*args), 2)
        note = profiler_note(lambda: kbsr.bsr_spmm_cuda(*args, cols),
                             min(reps, 10), "bsr_spmm_kernel")
        # What the listed route must move: the R values of every listed
        # column, the lists, the pattern, X and Y, each once; 2 R k
        # operations per listed column.  The dense walk beside it: every
        # stored block, 2 R C k operations per block, zeros included.
        k_rhs = Xt.shape[1]
        size = M.data.element_size()
        nbytes = listed * M.R * size + sum(
            x.numel() * x.element_size() for x in (
                *cols, M.indptr, M.indices[:nblk], Xt, Y))
        flops = 2 * listed * M.R * k_rhs
        dense_bytes = sum(x.numel() * x.element_size() for x in (
            M.data[:nblk], M.indptr, M.indices[:nblk], Xt, Y))
        dense_flops = 2 * nblk * M.R * M.C * k_rhs
        dense_bound = bound_record(dense_bytes, dense_flops)
        rec = dict(abs_err=err, ms=ms, plain_ms=plain_ms, blocks=nblk,
                   listed_columns=listed, kernel_without_lists_ms=raw_ms,
                   lists_plain_ms=lists_plain_ms, bytes=nbytes, flops=flops,
                   x_rows_read_bytes=listed * k_rhs * size,
                   dense_bound_ms=dense_bound["bound_ms"],
                   dense_bound_by=dense_bound["bound_by"],
                   **bound_record(nbytes, flops))
        # the library call: torch.sparse BSR @ X, else the CSR product
        try:
            lib = torch.sparse_bsr_tensor(
                M.indptr.long(), M.indices[:nblk].long(), M.data[:nblk],
                size=(M.mb * M.R, M.nb * M.C))
            Xl = Xt if M.nb * M.C == M.n else torch.cat([Xt, torch.zeros(
                (M.nb * M.C - M.n, Xt.shape[1]), dtype=Xt.dtype, device=dev)])
            Yl = (lib @ Xl)[: M.m]
            which = "torch.sparse BSR"
        except (RuntimeError, ValueError) as e:
            log(f"bsr[{label}]: torch.sparse BSR @ X refused "
                f"({str(e)[:80]}); timing the CSR product instead")
            lib, Xl = _csr_tensor(S, dev, np.float32), Xt
            Yl = lib @ Xl
            which = "torch.sparse CSR"
        if float((Yl - Y).abs().max()) > 1e-4 * float(Y.abs().max()):
            raise AssertionError(f"bsr[{label}]: library product disagrees")
        del Yl
        for _ in range(2):
            lib @ Xl
        rec["library_ms"] = cuda_ms(lambda: lib @ Xl, 5)
        del lib, Xl
        log(f"bsr[{label}]: blocks={nblk} listed_columns={listed} "
            f"({listed / nblk:.2f} of {M.C} per block; lists "
            f"{sum(x.numel() * 4 for x in cols)} bytes) flops={flops} "
            f"bytes={nbytes} (X rows if none is reused: "
            f"{rec['x_rows_read_bytes']}) kernel_device_ms_per_launch="
            f"{ms:.6f} "
            f"plain_walk_of_the_lists_device_ms={lists_plain_ms:.6f} (cuda events "
            f"around queued launches; runs plain,kernel,kernel,plain = {t}) "
            f"kernel_without_lists_device_ms={raw_ms:.6f} "
            f"dense_plain_device_ms={plain_ms:.6f}; {note}; "
            f"bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}); the dense "
            f"walk: flops={dense_flops} bytes={dense_bytes} bound_ms="
            f"{rec['dense_bound_ms']:.6f} ({rec['dense_bound_by']}); "
            f"library_{which.replace(' ', '_').replace('.', '_')}_f32_"
            f"device_ms={rec['library_ms']:.6f}")
        out[label] = rec
        torch.cuda.empty_cache()

    # the same product from the 1.1M entries (spmm without a block shape)
    Ys = pt.spmm(Bm, Xb_t)
    if float((Ys - Y_b).abs().max()) > 1e-4 * float(Y_b.abs().max()):
        raise AssertionError("bsr: entry-stream spmm disagrees")
    del Ys
    stream_ms = cuda_ms(lambda: pt.spmm(Bm, Xb_t), 2)
    log(f"bsr[ybus200k]: entry-stream spmm(block=None) device_ms_per_call="
        f"{stream_ms:.6f} (index_select + index_add_ over {Bm.nnz} entries "
        f"x {K_RHS}; the matrix and its entry streams are placed once)")

    def blocked():
        return pt.spmm(Bm, Xb_t, block=(8, 128))

    wall, busy = wall_ms(blocked, 5), queued_ms(blocked, 5)
    log(f"bsr[ybus200k]: spmm(block=(8, 128)) wall_ms_per_call={wall:.6f} "
        f"device_ms_per_call={busy:.6f} idle_share="
        f"{max(0.0, 1 - busy / wall):.4f} (5 calls, host clock against "
        f"queued device time)")
    del Xb_t, Y_b, placed, bsr_b
    Bm._bsr_cache = None
    torch.cuda.empty_cache()

    # ---- BSRMatMatPlan(A, A).numeric against scipy's A @ A
    t0 = time.perf_counter()
    mm = pt.BSRMatMatPlan(A, A)  # device=None: the card
    C = mm.numeric(A.data, A.data)
    torch.cuda.synchronize()
    t_mm = time.perf_counter() - t0
    ref = (S_a @ S_a).tobsr(blocksize=(Rb, Rb))
    ref.sort_indices()
    cip, cix, cdt = C.np_arrays()
    if not (np.array_equal(cip, ref.indptr)
            and np.array_equal(cix, ref.indices)):
        raise AssertionError("bsr: block pattern of A @ A differs from scipy's")
    # positive values: |A||A| = A A; a row of a block pair sums 32 products
    # and an output block up to bpr pairs of them
    kk = bpr * Rb
    r_mm = float((np.abs(cdt - ref.data) / ((kk + 2) * 2.0 ** -24 * 1.01
                                            * ref.data + 1e-300)).max())
    log(f"bsr[block32]: BSRMatMatPlan(A, A).numeric: {mm.pa.numel()} block "
        f"pairs -> {mm.out_nblocks} output blocks, pattern equal to scipy's, "
        f"worst_entry_err_over_bound={r_mm:.4f} (bound: ({kk}+2) 2^-24 "
        f"(A A) per entry; must be <= 1) seconds={t_mm:.3f} (host symbolic "
        f"included)")
    if not r_mm <= 1:
        raise AssertionError("bsr: BSRMatMatPlan disagrees with scipy")
    del C, mm

    # ---- ragged k and empty block rows at a small shape
    i = np.arange(100)
    Sd = sp.csr_matrix((np.random.RandomState(2).rand(100) + 0.5, (i, i)),
                       shape=(300, 300)) + sp.random(
        300, 300, density=0.02, format="csr",
        random_state=np.random.RandomState(3))
    Sd = Sd.tolil()
    Sd[160:200] = 0  # block rows 20..24 of (8, 128) hold nothing
    Sd = Sd.tocsr().astype(np.float32)
    Sd.eliminate_zeros()
    small = pt.CSC.from_scipy(Sd.tocsc(), device=dev).to_bsr(block=(8, 128))
    for k in (None, 1, 130):
        Xs = np.random.RandomState(4).rand(*((300,) if k is None
                                             else (300, k))).astype(np.float32)
        Xs_t = torch.as_tensor(Xs, device=dev)
        Ys = small @ Xs_t
        nb_ = small.nnz_blocks
        Ysp = kbsr.bsr_spmm_plain(300, 300, small.indptr, small.indices[:nb_],
                                  small.data[:nb_], Xs_t)
        _bsr_row_check(f"small k={k}", Ys, Ysp,
                       _bsr_row_bound(Sd.astype(np.float64), Xs, dev))
        if Ys.shape != Xs.shape or float(Ys[160:200].abs().max()) != 0.0:
            raise AssertionError("bsr: empty block rows are not exact zeros")
    log(f"bsr: phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, out


def newton_case(name, grid, dev, solves=1, profile_solve=False):
    import torch

    from csparse3_tpu_torch.models.powerflow import (NewtonPowerFlow,
                                                     _make_yplan)

    t0 = time.perf_counter()
    pf = NewtonPowerFlow(grid, spmv="bandpoints", solver="level", tol=5e-5,
                         device=dev)
    t_build = time.perf_counter() - t0
    plan = pf._yplan
    pf.solve()  # warm-up: first-use allocations
    times = []
    for _ in range(solves):
        plan.kernel_launches = 0
        t0 = time.perf_counter()
        vm, va, it, res = pf.solve()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = plan.kernel_launches
    hm = host_mismatch(grid, pf.Y, vm, va)
    rp = pf._rp
    log(f"newton[{name}]: buses={grid.n_bus} iterations={it} "
        f"residual={res:.3e} host_f64_mismatch={hm:.3e} "
        f"kernel_launches={launches} build_s={t_build:.3f} "
        f"solve_s={[round(t, 4) for t in times]} "
        f"jacobian_dim={rp.n} lnz={rp.lnz} unz={rp.unz} "
        f"refactor_levels={rp.nlevels} refactor_updates={rp.upd_dst.numel()} "
        f"solve_levels=({rp._ltpl.nlevels}, {rp._utpl.nlevels})")
    if profile_solve:
        wall, busy, nk, by = device_profile(pf.solve, 1)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:6]
        log(f"newton[{name}]: profiled solve wall_s={wall:.4f} "
            f"device_busy_s={busy:.4f} idle_share={1 - busy / wall:.4f} "
            f"kernels={nk} top_by_device_s=" + "; ".join(
                f"{k[:60]} x{c} {s:.4f}" for k, (c, s) in top))
    if not res <= pf.tol or it >= pf.max_iter:
        raise AssertionError(f"{name}: did not converge ({it} its, {res})")
    if hm > HOST_MISMATCH:
        raise AssertionError(f"{name}: host mismatch {hm} > {HOST_MISMATCH}")
    # one launch per mismatch evaluation: it + 1 of them
    if launches == 0 or launches != it + 1:
        raise AssertionError(f"{name}: {launches} launches for {it + 1} "
                             f"mismatch evaluations")
    # the float64 'ell' solve: the same solver with the gather plan in place
    # of the kernel's.  The Jacobian pattern does not depend on the SpMV
    # plan, so the host factorization and the refactor plan are shared
    # instead of built a second time (about a minute of host work at 10k
    # buses)
    t0 = time.perf_counter()
    pf_ell = copy.copy(pf)
    pf_ell._yplan = _make_yplan(pf.Y, "ell", dev)
    pf_ell.tol = 1e-10
    vm_e, va_e, it_e, res_e = pf_ell.solve()
    diff = max(np.abs(vm - vm_e).max(), np.abs(va - va_e).max())
    log(f"newton[{name}]: ell_f64 iterations={it_e} residual={res_e:.3e} "
        f"max_state_diff_vs_bandpoints={diff:.3e} bound={STATE_ATOL:.0e} "
        f"seconds={time.perf_counter() - t0:.3f}")
    if not res_e < 1e-8 or diff > STATE_ATOL:
        raise AssertionError(f"{name}: bandpoints and ell disagree")
    return launches, (vm_e, va_e)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    t_all = time.perf_counter()
    build_phase()

    from csparse3_tpu_torch.utils.roofline import H100_HBM_BYTES_PER_S

    global HBM_BYTES_PER_S
    HBM_BYTES_PER_S = H100_HBM_BYTES_PER_S

    from csparse3_tpu_torch.models.grids import ieee14, synthetic_grid

    with torch.inference_mode():
        tri, bw = triad_phase(dev)
        k = kernel_phase(dev)
        dia = dia_phase(dev, bw)
        t0 = time.perf_counter()
        launches, ell_state = newton_case(
            "synthetic10k", synthetic_grid(N_SOLVE, seed=3), dev,
            profile_solve=True)
        log(f"newton[synthetic10k]: phase seconds "
            f"{time.perf_counter() - t0:.1f}")
        dia_launches, band = banded_phase(dev, ell_state)
        newton_case("ieee14", ieee14(), dev)
        # last: these phases time with CUDA events alone, so torch.profiler
        # dropping records late in a long process costs them nothing
        spg_launches, spg = spgemm_phase(dev)
        bsr_launches, bsr = bsr_phase(dev)

    def record(name, src, replaces, launches, r):
        return {"name": name, "route": "cuda",
                "source": f"csparse3_tpu_torch/csrc/{src}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": r["abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    log(json.dumps({"kernels": [
        # the top-level numbers are one launch of the default plan at 200k
        # buses (K1; K2 is the same kernel); points_groups is the plan with
        # group_span=512 (K3's offset groups), one launch per call over the
        # groups' joined lists, equal to the default plan's result; its
        # library call is the same complex64 CSR product
        dict(record("bandpoints_spmv", "bandpoints",
                    "csparse3_tpu/kernels/bandpoints.py:546", launches,
                    k["default"]),
             cold_l2_ms=k["default"]["cold_l2_ms"],
             points_groups=dict(
                 replaces="csparse3_tpu/kernels/bandpoints.py:266",
                 **{key: k["groups"][key] for key in (
                     "n_groups", "launches_per_call", "ms", "plain_ms",
                     "bound_ms", "bound_by", "library_ms", "abs_err")})),
        # the top-level numbers are one launch of the split-complex run
        # kernel at the shape the banded solves give it (float64, D=473,
        # n=10k, both real slab sets through the occupancy index they share,
        # x (n, 2)): the launches counted are those launches.  bound_ms
        # counts what the route moves: the listed runs (streamed whole, their
        # zeros included), the index, x and y; nonzero_bound_ms the nonzero
        # values, a position for each, x and y: the least any layout needs;
        # dense_bound_ms every slab value, as the dense kernel
        # (dense_kernel_ms, one launch per slab set on the raw slabs) reads
        # them.  plain_ms is the dense plain version, runs_plain_ms the plain
        # walk of the index; one_slab_set_ms is the run kernel on one slab
        # set and the stacked (2, n) input
        dict(record("dia_spmv", "dia_spmv",
                    "csparse3_tpu/kernels/dia_pallas.py:67", dia_launches,
                    band["dia"]),
             shape=f"float64 general form, both slab sets of the {N_SOLVE}"
                   "-bus RCM Ybus through their shared occupancy index, per "
                   "split-complex launch; library_ms is the complex128 CSR "
                   "product",
             **{k: band["dia"][k] for k in (
                 "runs_plain_ms", "one_slab_set_ms", "dense_kernel_ms",
                 "nonzero_bound_ms", "dense_bound_ms", "listed_runs",
                 "index_bytes")},
             symmetric_form=band["symdia"],
             # per SplitDIA / SplitSymDIA call (1 launch) on the 200k-bus
             # RCM Ybus, float32; the library call is the complex64 CSR
             # product; two_launches_ms is one launch per slab set
             full_size_float32=dict(
                 shape=f"float32, both slab sets of the {N_KERNEL}-bus RCM "
                       "Ybus, per split-complex call of 1 launch",
                 launches_per_call=1, general_form=dia["dia"],
                 symmetric_form=dia["symdia"])),
        record("triad", "triad", "probes/_probe_pallas.py:38",
               tri["launches"], tri),
        # the top-level numbers are one launch on the 200k-bus grid's
        # connectivity product (float32): of the launches counted, one per
        # numeric call of the three SpGEMMPlans and the three GramPlans
        dict(record("spgemm_numeric", "spgemm_numeric",
                    "csparse3_tpu/kernels/spgemm_pallas.py:109", spg_launches,
                    spg["conn200k"]),
             shape=f"float32, C @ C.T of the {N_KERNEL}-bus grid's "
                   "connectivity matrix, per launch; library_ms is "
                   "torch.sparse.mm (symbolic and numeric together); "
                   "least_bytes_bound_ms counts the maps, values, output "
                   "and one bit per product; launch_floor_ms is the kernel "
                   "on a plan of one output; esc_* the device ESC product",
             **{k: spg["conn200k"][k] for k in (
                 "outputs_per_thread", "least_bytes_bound_ms",
                 "launch_floor_ms", "esc_wall_ms", "esc_queued_ms")},
             conn3000=spg["conn3000"], rand10k=spg["rand10k"]),
        # the top-level numbers are spmm(B, X, block=(8, 128)) on the
        # 200k-bus susceptance matrix, through its column lists; the
        # launches counted are that product and the 32x32 block matrix's.
        # bound_ms counts the listed columns' values and operations,
        # dense_bound_ms every stored block's; plain_ms is the plain version
        # over every column, lists_plain_ms its walk of the same lists
        dict(record("bsr_spmm", "bsr_spmm",
                    "csparse3_tpu/kernels/bsr_spmm_pallas.py:71",
                    bsr_launches, bsr["ybus200k"]),
             shape=f"float32, imag(Ybus) of the {N_KERNEL}-bus grid in "
                   "(8, 128) blocks times X (n, 1024), the occupied columns "
                   "only, per launch",
             **{k: bsr["ybus200k"][k] for k in (
                 "kernel_without_lists_ms", "lists_plain_ms",
                 "dense_bound_ms", "dense_bound_by", "listed_columns")},
             block_matrix_32x32=bsr["block32"]),
    ]}))
    log(f"total seconds {time.perf_counter() - t_all:.1f}")
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
