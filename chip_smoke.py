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
7. multifrontal: the same grid and tolerance with solver='multifrontal'
           (``MultifrontalLU``: a from-scratch front factorization with
           partial pivoting inside each front, every iteration): build
           seconds (the generic-value splu and the front build apart), three
           warm solves, the front statistics and one solve under
           torch.profiler (idle share, launches per iteration, top device
           ops).  It must converge without the pivot-growth gate engaging,
           give a host float64 mismatch <= 1e-4, launch K1 once per mismatch
           evaluation and agree with phase 6's 'ell' state within 1e-4; the
           same front plan with spmv='ell' must converge to 1e-10 in
           float64.  Then the refactorizations alone on the JAX bench's
           B + 3I system (``MultifrontalRefactor`` at 10k buses,
           ``SupernodalRefactor`` at 3000; float32 and float64; the level
           ``RefactorPlan`` at 10k in float64): ms per
           ``factor_values`` call, wall and queued, the factors against the
           host's and a solve's relative residual (< 1e-3 in float32,
           < 1e-10 in float64).  Last, IEEE-14 with solver='multifrontal'.
8. banded: the same grid in RCM order (``rcm_grid``):
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
9. blocklu: the banded block-Thomas solvers on the same RCM-ordered grid:
           FastDecoupled(spmv='symdia', solver='blocklu') and ('banded')
           must converge to 1e-8, agree with phase 8's Newton state within
           1e-6 and launch the DIA kernel 3 it + 2 times; their build and
           warm solve seconds beside 'level''s, and one profiled solve each
           (launches, idle share).  NewtonPowerFlow(spmv='dia',
           solver='blocklu') in float64: host mismatch <= 1e-8, state within
           1e-8 of phase 6's 'ell' state, one DIA launch per mismatch.
           BASELINE config 3 (B + 3I of synthetic_grid(10_000, seed=1),
           1024 right-hand sides, float64): ``splu(A, 'rcm', tol=0)
           .banded_solve_plan()`` and ``BandedLU(A)``, relative residual
           <= 1e-10 and scipy's splu on 16 columns within 1e-10; BASELINE
           config 4 (the same at 100k buses): ``BandedRefactor.from_matrix``
           then the device factor in float32 and float64 and a 1024-RHS
           solve, on 16 columns within 1e-3 (float32) and 1e-10 (float64)
           of the host float64 ``BandedLU.solve_host``.  Wall and queued ms
           of each solve and factor beside its flop bound.
10. ieee14: phase 6 on ieee14().
11. studies: the batched study path on synthetic_grid(10_000, seed=3)
           (22,263 branches), every scenario set made from RandomState(0):
           ``NewtonPowerFlow('bandpoints', 'multifrontal', tol=5e-5)
           .solve_batch`` of 32 load scenarios (host float64 mismatch of
           each <= 1e-4, 4 of them within 1e-4 of single solves, K1 once per
           batched mismatch evaluation); on the RCM-ordered grid
           ``FastDecoupled('symdia', 'blocklu').solve_batch`` of 256
           scenarios (each within 1e-6 of its single solve, with its
           iteration count; K4 3 it + 2 times with the batch's residual
           check) and ``NewtonPowerFlow('dia', 'blocklu').solve_batch`` of
           16; ``DCContingency`` over all 22,263 outages (batch printed; 32
           sampled outages' flows within 1e-8 of scipy spsolve, ``ok`` equal
           to a host islanding check on those and on every flagged one);
           ``LinearContingency`` over all outages (the same flows within
           1e-8 where neither islands, equal ``ok``); ``ACContingency(
           solver='multifrontal')`` on 128 outages (4 against the host
           Newton within 1e-6); ``short_circuit`` at all 10,000 buses (16 Z
           columns within 1e-10 of scipy splu); ``parse_case`` of IEEE-14
           text through Newton.  Wall seconds and scenarios/s of each study;
           the batched K1 and K4 kernels (scenario-minor x, one launch a
           batch; the timed solve_batch calls must go through them) alone
           against their plain versions on the same batch and bit-equal to
           one launch per scenario, at each K of a sweep (K1: 1, 8, 32,
           128; K4 symmetric: 1, 16, 64, 256, general: 16), with queued ms
           of the launch on its own layout, of the plan's whole call from
           (K, n) parts and per scenario, beside the bound and the library
           call (torch.sparse CSR @ X (n, K)).
12. spgemm: the sparse-product path on three matrices: C = Cf - Ct of
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
13. bsr:   the block product ``Y = A @ X``: the 16384^2 matrix of 32 x 32
           blocks (6 per block row) with X (16384, 1024), and
           ``spmm(B, X, block=(8, 128))`` for B = imag(Ybus) of the 200k-bus
           grid in float32 with X (200000, 1024); the BSR SpMM kernel
           through the containers' column lists (the occupied columns of
           each block) and without them, against the plain version, the
           plain walk of the lists and scipy float64 row by row within
           the rounding bound, bit-equal on a second launch, k = 1 and
           k = 130 and empty block rows at a small shape,
           ``BSRMatMatPlan(A, A).numeric`` against scipy's
           ``A @ A``, with its wall and queued ms per call; times of kernel,
           plain version, the library call (torch.sparse BSR ``@ X``) and
           the entry-stream ``spmm``.

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
# float64 matrix products on the tensor cores (DGEMM), the same sheet
F64_TENSOR_FLOP_PER_S = 67e12

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
# banded float64 solves: the relative residual ||AX - B|| / ||B|| and the
# gap to scipy's splu (or the host BandedLU) over max|x|
BANDED_RESIDUAL = 1e-10
BANDED_RTOL = 1e-10
# the float32 device factor and solve against the host float64 solve, over
# max|x| (the JAX bench's gate for its float32 banded solves, bench.py:308)
BANDED_F32_RTOL = 1e-3
N_BANDED_LARGE = 100_000  # buses of BASELINE config 4
N_RHS = 1024              # right-hand sides of BASELINE configs 3 and 4


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


def queued_ms(fn, reps, spin_ms=0.0):
    """Device ms per call of ``reps`` back-to-back calls, without the host
    in the way: the calls are enqueued while a spin kernel keeps the card
    busy, so they run one behind the other, and CUDA events on the stream
    bracket them.  For a call of one short kernel this is its device time
    plus the gap between two launches.  Only for calls that do not wait for
    the device themselves: such a call would sit out the spin kernel.  A
    call of many launches needs ``spin_ms`` above the host's time to
    enqueue all ``reps`` calls."""
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    # ~20 ms, or 0.25 ms for every call, or spin_ms (~2e6 cycles a ms): the
    # host gets ahead meanwhile
    torch.cuda._sleep(int(max(40e6, reps * 5e5, spin_ms * 2e6)))
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
    flow.  Returns the DIA kernel's launches over the three solves, its
    records at this path's shape, and the grid, its RCM permutation, the
    Newton state and the 'symdia' fast-decoupled solver for the blocklu
    phase."""
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
    return launches, recs, dict(grid=g, perm=perm, newton=(vm, va),
                                level=fds["symdia"])


def _sweep_record(name, plan, solve, X, ref, limit, dtype, flops, nbytes):
    """Wall and queued ms of ``solve`` (a call of many launches), its
    error on the first columns against ``ref`` over max|ref|, and the bound
    of ``flops`` and ``nbytes``."""
    cols = ref.shape[1]
    err = float(np.abs(X[:, :cols].double().cpu().numpy() - ref).max()
                / np.abs(ref).max())
    wall = wall_ms(solve, 3)
    queued = queued_ms(solve, 3, spin_ms=2 * 3 * wall)
    rate = F64_TENSOR_FLOP_PER_S if dtype == "float64" else F32_FLOP_PER_S
    rec = dict(s=plan.s, nb=plan.nblocks, wall_ms=wall, queued_ms=queued,
               err=err, flops=flops, bytes=nbytes,
               **bound_record(nbytes, flops, rate))
    log(f"blocklu: {name} {dtype} s={plan.s} nb={plan.nblocks} "
        f"rhs={X.shape[1]} solve wall_ms={wall:.3f} queued_ms={queued:.3f} "
        f"flops={flops:.4g} bytes={nbytes:.4g} bound_ms={rec['bound_ms']:.3f}"
        f" ({rec['bound_by']}) share_of_bound={rec['bound_ms'] / queued:.3f} "
        f"err_vs_reference_over_max={err:.3e} (limit {limit:.0e})")
    if not err <= limit:
        raise AssertionError(f"blocklu: {name} {dtype} disagrees ({err})")
    return rec


def blocklu_phase(dev, ctx, ell_state):
    """The banded block-Thomas solvers at full size: fast-decoupled with
    solver='blocklu' and 'banded' on the banded phase's 10k grid, Newton
    'blocklu' on it, then BASELINE configs 3 (B + 3I at 10k buses, 1024
    right-hand sides: ``banded_solve_plan`` and ``BandedLU``) and 4 (100k
    buses: ``BandedRefactor`` device factors in float32 and float64, then
    a 1024-RHS solve).  Returns the DIA kernel's launches over the solves
    of the main path (the three power-flow solves) and the records."""
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.linalg import BandedLU, BandedRefactor, splu
    from csparse3_tpu_torch.models.powerflow import (FastDecoupled,
                                                     NewtonPowerFlow)

    t_phase = time.perf_counter()
    g, perm = ctx["grid"], ctx["perm"]
    vm_n, va_n = ctx["newton"]
    out = {}

    # ---- (a) fast-decoupled, 10k buses, RCM order, 'symdia'
    fds = {"level": (ctx["level"], None)}
    for solver in ("blocklu", "banded"):
        t0 = time.perf_counter()
        fd = FastDecoupled(g, spmv="symdia", solver=solver, device=dev)
        fds[solver] = (fd, time.perf_counter() - t0)
        fd.solve()  # warm-up: first-use allocations and uploads
    # the main path: counts to 0, one solve each, counts read
    launches = 0
    for solver in ("blocklu", "banded"):
        fd = fds[solver][0]
        for key in kdia.LAUNCHES:
            kdia.LAUNCHES[key] = 0
        vm, va, it, res = fd.solve()
        torch.cuda.synchronize()
        nl = kdia.LAUNCHES["dia_spmv"]
        launches += nl
        diff = max(np.abs(vm - vm_n).max(), np.abs(va - va_n).max())
        log(f"blocklu: fdpf[{solver}] iterations={it} residual={res:.3e} "
            f"kernel_launches={nl} max_state_diff_vs_newton={diff:.3e} "
            f"(bound {FDPF_STATE_ATOL:.0e})")
        if not res <= fd.tol or it >= fd.max_iter:
            raise AssertionError(f"fdpf[{solver}]: did not converge")
        if diff > FDPF_STATE_ATOL:
            raise AssertionError(f"fdpf[{solver}]: disagrees with Newton")
        if nl == 0 or nl != 3 * it + 2:
            raise AssertionError(f"fdpf[{solver}]: {nl} launches for {it} "
                                 "iterations")
    # warm solve seconds of the three solvers in turns, then one profiled
    # solve of each new one ('level''s profile is the banded phase's)
    times = {k: [] for k in fds}
    for _ in range(3):
        for solver, (fd, _) in fds.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fd.solve()
            torch.cuda.synchronize()
            times[solver].append(time.perf_counter() - t0)
    log(f"blocklu: fdpf[level] warm_solve_s="
        f"{[round(t, 4) for t in times['level']]}")
    for solver in ("blocklu", "banded"):
        fd, build = fds[solver]
        wall, busy, nk, by = device_profile(fd.solve, 1)
        top = sorted(by.items(), key=lambda kv: -kv[1][1])[:4]
        log(f"blocklu: fdpf[{solver}] B' s={fd._bp_plan.s} "
            f"nb={fd._bp_plan.nblocks} B'' s={fd._bpp_plan.s} "
            f"nb={fd._bpp_plan.nblocks} build_s={build:.3f} warm_solve_s="
            f"{[round(t, 4) for t in times[solver]]} profiled wall_s="
            f"{wall:.4f} device_busy_s={busy:.4f} idle_share="
            f"{1 - busy / wall:.4f} launches_per_solve={nk} top_by_device_s="
            + "; ".join(f"{k[:50]} x{c} {t:.4f}" for k, (c, t) in top))
        out[f"fdpf_{solver}"] = dict(solve_s=min(times[solver]),
                                     idle_share=1 - busy / wall, launches=nk)
    log(f"blocklu: (a) seconds {time.perf_counter() - t_phase:.1f}")

    # ---- (b) Newton 'blocklu', float64 DIA mismatch
    t0 = time.perf_counter()
    pf = NewtonPowerFlow(g, spmv="dia", solver="blocklu", device=dev)
    t_build = time.perf_counter() - t0
    pf.solve()  # warm-up
    for key in kdia.LAUNCHES:
        kdia.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    vm, va, it, res = pf.solve()
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    nl = kdia.LAUNCHES["dia_spmv"]
    launches += nl
    hm = host_mismatch(g, pf.Y, vm, va)
    vm_e, va_e = ell_state
    diff = max(np.abs(vm - vm_e[perm]).max(), np.abs(va - va_e[perm]).max())
    wall, busy, nk, _ = device_profile(pf.solve, 1)
    n_j, s, nb, bw = pf._rp._aux
    log(f"blocklu: newton[blocklu] jacobian_dim={n_j} bandwidth={bw} s={s} "
        f"nb={nb} iterations={it} residual={res:.3e} host_f64_mismatch="
        f"{hm:.3e} (bound {DIA_HOST_MISMATCH:.0e}) kernel_launches={nl} "
        f"build_s={t_build:.3f} solve_s={t_solve:.4f} profiled wall_s="
        f"{wall:.4f} idle_share={1 - busy / wall:.4f} launches_per_iteration="
        f"{nk / max(it, 1):.0f} max_state_diff_vs_ell_of_natural_order="
        f"{diff:.3e} (bound {DIA_STATE_ATOL:.0e})")
    if not res <= pf.tol or it >= pf.max_iter:
        raise AssertionError(f"newton[blocklu]: did not converge ({it})")
    if hm > DIA_HOST_MISMATCH or diff > DIA_STATE_ATOL:
        raise AssertionError("newton[blocklu]: wrong state")
    if nl == 0 or nl != it + 1:
        raise AssertionError(f"newton[blocklu]: {nl} launches for {it + 1} "
                             "mismatch evaluations")
    out["newton_blocklu"] = dict(solve_s=t_solve, iterations=it, s=s, nb=nb,
                                 launches_per_iteration=nk / max(it, 1))
    log(f"blocklu: (b) seconds {time.perf_counter() - t_phase:.1f}")

    # ---- (c) BASELINE config 3: B + 3I at 10k buses, 1024 right-hand sides
    A = refactor_system(N_SOLVE)
    S = A.to_scipy().tocsc()
    Bm = np.random.RandomState(1).rand(A.n, N_RHS)
    ref = spla.splu(S).solve(Bm[:, :16])
    Bt = torch.as_tensor(Bm, device=dev)
    t0 = time.perf_counter()
    bsp = splu(A, ordering="rcm", tol=0.0).banded_solve_plan(device=dev)
    t_bsp = time.perf_counter() - t0
    t0 = time.perf_counter()
    blu = BandedLU(A, device=dev)
    t_blu = time.perf_counter() - t0
    for name, plan, build, per_block in (("banded_solve_plan", bsp, t_bsp, 4),
                                         ("BandedLU", blu, t_blu, 3)):
        X = plan(Bt)
        res = float(np.linalg.norm(S @ X.cpu().numpy() - Bm)
                    / np.linalg.norm(Bm))
        # per block per_block (s, s) @ (s, 1024) products; the stacks read
        # once, B in, X out
        nstack = per_block * plan.nblocks * plan.s ** 2
        rec = _sweep_record(
            f"config3[{name}]", plan, lambda: plan(Bt), X, ref,
            BANDED_RTOL, "float64", 2.0 * nstack * N_RHS,
            8 * (nstack + 2 * A.n * N_RHS))
        rec.update(build_s=build, rel_residual=res)
        log(f"blocklu: config3[{name}] build_s={build:.3f} "
            f"rel_residual={res:.3e} (limit {BANDED_RESIDUAL:.0e})")
        if not res <= BANDED_RESIDUAL:
            raise AssertionError(f"config3[{name}]: residual {res}")
        out[f"config3_{name}"] = rec
    del X, Bt, bsp, blu
    log(f"blocklu: (c) seconds {time.perf_counter() - t_phase:.1f}")

    # ---- (d) BASELINE config 4: B + 3I at 100k buses
    A = refactor_system(N_BANDED_LARGE)
    data = A.np_arrays()[2]
    Bm = np.random.RandomState(1).rand(A.n, N_RHS)
    t0 = time.perf_counter()
    host = BandedLU(A, device=dev)
    t_host = time.perf_counter() - t0
    ref = host.solve_host(Bm[:, :16])
    for dt, limit in (("float32", BANDED_F32_RTOL), ("float64", BANDED_RTOL)):
        dtype = getattr(torch, dt)
        t0 = time.perf_counter()
        rf = BandedRefactor.from_matrix(A, dtype=dtype, device=dev)
        t_rf = time.perf_counter() - t0
        d = torch.as_tensor(data, dtype=dtype, device=dev)
        lu = rf(d)
        f_wall = wall_ms(lambda: rf(d), 3)
        f_queued = queued_ms(lambda: rf(d), 3, spin_ms=2 * 3 * f_wall)
        n, s, nb, bw = rf._aux
        f_flops = 8.0 * s ** 3 * nb  # three products and an inverse a block
        rate = F64_TENSOR_FLOP_PER_S if dt == "float64" else F32_FLOP_PER_S
        log(f"blocklu: config4 {dt} n={n} bandwidth={bw} s={s} nb={nb} "
            f"from_matrix_s={t_rf:.3f} host_BandedLU_s={t_host:.3f} "
            f"device factor wall_ms={f_wall:.3f} queued_ms={f_queued:.3f} "
            f"factor_flops={f_flops:.4g} factor_bound_ms="
            f"{f_flops / rate * 1e3:.3f}")
        Bt = torch.as_tensor(Bm, dtype=dtype, device=dev)
        X = lu(Bt)
        nstack = 3 * nb * s ** 2
        rec = _sweep_record(
            "config4[BandedRefactor]", lu, lambda: lu(Bt), X, ref, limit, dt,
            2.0 * nstack * N_RHS,
            X.element_size() * (nstack + 2 * n * N_RHS))
        rec.update(factor_wall_ms=f_wall, factor_queued_ms=f_queued,
                   factor_bound_ms=f_flops / rate * 1e3, from_matrix_s=t_rf)
        out[f"config4_{dt}"] = rec
        del X, Bt, lu, rf, d
        torch.cuda.empty_cache()
    log(f"blocklu: phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches, out


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
    # F2: the numeric pass alone (torch.bmm + index_add_, no kernel of ours)
    mm_wall = wall_ms(lambda: mm.numeric(A.data, A.data), 20)
    mm_queued = queued_ms(lambda: mm.numeric(A.data, A.data), 20)
    log(f"bsr[block32]: BSRMatMatPlan.numeric wall_ms={mm_wall:.4f} "
        f"queued_ms={mm_queued:.4f} per call (20 calls each)")
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

def _gate_engaged(caught):
    return any("pivot-growth gate" in str(w.message) for w in caught)


def refactor_system(ng):
    """The JAX bench's ``run_refactor_general`` matrix (``bench.py:588-620``):
    B + 3I for the series susceptances B of synthetic_grid(ng, seed=1)."""
    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.models.grids import synthetic_grid

    g = synthetic_grid(ng, seed=1)
    bp = 1.0 / g.x
    diag = np.arange(ng)
    return pt.from_triplets(
        np.concatenate([g.f, g.t, g.f, g.t, diag]),
        np.concatenate([g.f, g.t, g.t, g.f, diag]),
        np.concatenate([bp, bp, -bp, -bp, np.full(ng, 3.0)]), (ng, ng))


def refactor_case(name, make_plan, ng, dev, dtypes=("float32", "float64")):
    """A frozen-pivot refactorization alone on ``refactor_system(ng)``
    (``splu(..., ordering='nd', tol=0.0)``): build seconds, then per dtype
    the ms per ``factor_values`` call by the host clock and by queued CUDA
    events, Lx / Ux against the host factors (largest error over the largest
    factor entry) and the relative residual of a solve through
    ``refactor``.  Returns {dtype: record}."""
    import torch

    from csparse3_tpu_torch.linalg import splu

    A = refactor_system(ng)
    t0 = time.perf_counter()
    lu = splu(A, ordering="nd", tol=0.0)
    t_splu = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = make_plan(lu._h, A)
    t_build = time.perf_counter() - t0
    h = lu._h
    S = A.to_scipy().tocsc()
    b = np.random.RandomState(2).rand(ng)
    out = {}
    for dt, limit in ((getattr(torch, t), {"float32": 1e-3,
                                           "float64": 1e-10}[t])
                      for t in dtypes):
        d = torch.as_tensor(A.np_arrays()[2], dtype=dt, device=dev)
        Lx, Ux = plan.factor_values(d)
        wall = wall_ms(lambda: plan.factor_values(d), 5)
        queued = queued_ms(lambda: plan.factor_values(d), 5,
                           spin_ms=2 * 5 * wall)
        err = max(float(np.abs(F.double().cpu().numpy() - R).max()
                        / np.abs(R).max()) for F, R in ((Lx, h.Lx),
                                                        (Ux, h.Ux)))
        x = plan.refactor(d)(torch.as_tensor(b, dtype=dt, device=dev))
        x = x.double().cpu().numpy()
        res = float(np.linalg.norm(S @ x - b) / np.linalg.norm(b))
        out[str(dt).split(".")[1]] = dict(wall_ms=wall, queued_ms=queued,
                                          factor_err=err, rel_residual=res)
        log(f"refactor[{name}]: n={ng} {dt} factor_values wall_ms={wall:.3f} "
            f"queued_ms={queued:.3f} factors_err_over_max={err:.3e} "
            f"solve_rel_residual={res:.3e} (limit {limit:.0e})")
        if not res < limit:
            raise AssertionError(f"refactor[{name}]: residual {res}")
    log(f"refactor[{name}]: splu_s={t_splu:.3f} build_s={t_build:.3f} "
        f"lnz={h.Lx.size} unz={h.Ux.size} " + " ".join(
            f"{k}={getattr(plan, k)}" for k in ("nlevels", "ngroups",
                                                "nsnodes", "front_floats")
            if hasattr(plan, k)))
    return out


def multifrontal_phase(dev, level_state):
    """The Newton main path with solver='multifrontal' on the 10k grid
    (spmv='bandpoints', tol=5e-5, the JAX bench's newton10k), checked
    against the host float64 mismatch, K1's launch count, the growth gate
    (it must never engage) and the solver='level' float64 state
    ``level_state``; the same front plan with spmv='ell' in float64; the
    refactorizations alone; IEEE-14.  Returns K1's launches over the three
    timed solves."""
    import warnings

    import torch

    from csparse3_tpu_torch.linalg import (MultifrontalRefactor,
                                           RefactorPlan, SupernodalRefactor)
    from csparse3_tpu_torch.models.grids import ieee14, synthetic_grid
    from csparse3_tpu_torch.models.powerflow import (NewtonPowerFlow,
                                                     _make_yplan)

    t_phase = time.perf_counter()
    grid = synthetic_grid(N_SOLVE, seed=3)
    t0 = time.perf_counter()
    pf = NewtonPowerFlow(grid, spmv="bandpoints", solver="multifrontal",
                         tol=5e-5, device=dev)
    t_build = time.perf_counter() - t0
    rp, plan = pf._rp, pf._yplan
    times, launches = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pf.solve()  # warm-up: first-use allocations
        for _ in range(3):
            plan.kernel_launches = 0
            t0 = time.perf_counter()
            vm, va, it, res = pf.solve()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            launches.append(plan.kernel_launches)
        wall, busy, nk, by = device_profile(pf.solve, 1)
    hm = host_mismatch(grid, pf.Y, vm, va)
    diff = max(np.abs(vm - level_state[0]).max(),
               np.abs(va - level_state[1]).max())
    log(f"multifrontal[synthetic10k]: buses={grid.n_bus} iterations={it} "
        f"residual={res:.3e} host_f64_mismatch={hm:.3e} "
        f"kernel_launches_per_solve={launches} build_s={t_build:.3f} "
        f"(splu_generic_s={rp.build_s['splu']:.3f} "
        f"fronts_s={rp.build_s['fronts']:.3f}) "
        f"solve_s={[round(t, 4) for t in times]} "
        f"max_state_diff_vs_level_ell_f64={diff:.3e} bound={STATE_ATOL:.0e}")
    log(f"multifrontal[synthetic10k]: jacobian_dim={rp.n} lnz={rp.lnz} "
        f"unz={rp.unz} nsnodes={rp.nsnodes} nlevels={rp.nlevels} "
        f"ngroups={rp.ngroups} max_rmax="
        f"{max(g[3] for g in rp.group_static)} padded_front_floats="
        f"{rp.front_floats} (the JAX bench's note: 28.8M floats at 10k)")
    top = sorted(by.items(), key=lambda kv: -kv[1][1])[:8]
    log(f"multifrontal[synthetic10k]: profiled solve wall_s={wall:.4f} "
        f"device_busy_s={busy:.4f} idle_share={1 - busy / wall:.4f} "
        f"kernels={nk} kernels_per_iteration={nk / max(it, 1):.0f} "
        f"top_by_device_s=" + "; ".join(
            f"{k[:60]} x{c} {t:.4f}" for k, (c, t) in top))
    if _gate_engaged(caught):
        raise AssertionError("multifrontal: the pivot-growth gate engaged")
    if not res <= pf.tol or it >= pf.max_iter:
        raise AssertionError(f"multifrontal: did not converge ({it}, {res})")
    if hm > HOST_MISMATCH:
        raise AssertionError(f"multifrontal: host mismatch {hm}")
    if any(k != it + 1 for k in launches):
        raise AssertionError(f"multifrontal: {launches} launches for "
                             f"{it + 1} mismatch evaluations per solve")
    if diff > STATE_ATOL:
        raise AssertionError("multifrontal: state differs from 'level'")

    # float64 'ell' on the same front plan (the Jacobian pattern does not
    # depend on the SpMV plan)
    t0 = time.perf_counter()
    pf_ell = copy.copy(pf)
    pf_ell._yplan = _make_yplan(pf.Y, "ell", dev)
    pf_ell.tol = 1e-10
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        vm_e, va_e, it_e, res_e = pf_ell.solve()
    diff_e = max(np.abs(vm_e - level_state[0]).max(),
                 np.abs(va_e - level_state[1]).max())
    log(f"multifrontal[synthetic10k]: ell_f64 iterations={it_e} "
        f"residual={res_e:.3e} max_state_diff_vs_level_ell_f64={diff_e:.3e} "
        f"seconds={time.perf_counter() - t0:.3f}")
    if _gate_engaged(caught) or not res_e < 1e-8:
        raise AssertionError("multifrontal: ell f64 solve failed")

    # the refactorizations alone (the JAX bench's refactor_general system)
    refactor_case("multifrontal10k", lambda h, A: MultifrontalRefactor(
        h, A, device=dev), N_SOLVE, dev)
    refactor_case("supernodal3000", lambda h, A: SupernodalRefactor(
        h, A, device=dev), 3000, dev)
    # the level plan on the same 10k system (its build fits the phase:
    # ~10 s); it factors in the host factors' float64 whatever it is given
    refactor_case("level10k", lambda h, A: RefactorPlan(h, A, device=dev),
                  N_SOLVE, dev, dtypes=("float64",))

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g14 = ieee14()
        pf14 = NewtonPowerFlow(g14, solver="multifrontal", device=dev)
        vm14, va14, it14, res14 = pf14.solve()
    hm14 = host_mismatch(g14, pf14.Y, vm14, va14)
    log(f"multifrontal[ieee14]: iterations={it14} residual={res14:.3e} "
        f"host_f64_mismatch={hm14:.3e}")
    if _gate_engaged(caught) or not res14 <= pf14.tol or hm14 > 1e-8:
        raise AssertionError("multifrontal[ieee14]: failed")
    log(f"multifrontal: phase seconds {time.perf_counter() - t_phase:.1f}")
    return sum(launches)


# ---------------------------------------------------------------------------
# studies: the batched study path (scenario axis)
# ---------------------------------------------------------------------------

N_SCEN_NEWTON = 32     # load scenarios of the batched Newton solve
N_SCEN_FDPF = 256      # load scenarios of the batched fast-decoupled solve
N_SCEN_BLOCKLU = 16    # load scenarios of the batched Newton 'blocklu' solve
N_AC_OUTAGES = 128     # outages of the AC contingency
AC_BATCH = 32          # AC outages per batched Newton
N_SAMPLED = 32         # DC outages checked on the host
# batch sizes of the K1 and K4 sweeps (K4: the symmetric form; the general
# form at N_SCEN_BLOCKLU is added to its sweep)
K1_SWEEP = (1, 8, 32, 128)
K4_SWEEP = (1, 16, 64, 256)
# device bytes a DC contingency chunk may hold: a chunk's time is its
# launches (~9k: 880 levels in each triangular solve, 125 front groups)
# more than its bytes, so the chunk is as large as the card allows beside
# the results (22,263 x 22,263 flows, 4 GB)
STUDY_BYTES = 40e9
# the DC flows of a refactorization against scipy spsolve, and LODF
# screening against the refactorization, over the largest flow
DC_FLOW_RTOL = 1e-8
# batched Newton and FDPF rows against the one-scenario solves
FDPF_BATCH_ATOL = 1e-6
# Z columns of the device complex solves against scipy splu
Z_RTOL = 1e-10
# the AC contingency against the host Newton of the outaged grid
AC_STATE_ATOL = 1e-6

CASE14_TEXT = """
mpc.baseMVA = 100;
mpc.bus = [
 1 3 0 0 0 0 1 1.06 0 0 1 1.06 0.94;
 2 2 21.7 12.7 0 0 1 1.045 -4.98 0 1 1.06 0.94;
 3 2 94.2 19 0 0 1 1.01 -12.72 0 1 1.06 0.94;
 4 1 47.8 -3.9 0 0 1 1.019 -10.33 0 1 1.06 0.94;
 5 1 7.6 1.6 0 0 1 1.02 -8.78 0 1 1.06 0.94;
 6 2 11.2 7.5 0 0 1 1.07 -14.22 0 1 1.06 0.94;
 7 1 0 0 0 0 1 1.062 -13.37 0 1 1.06 0.94;
 8 2 0 0 0 0 1 1.09 -13.36 0 1 1.06 0.94;
 9 1 29.5 16.6 0 19 1 1.056 -14.94 0 1 1.06 0.94;
 10 1 9 5.8 0 0 1 1.051 -15.1 0 1 1.06 0.94;
 11 1 3.5 1.8 0 0 1 1.057 -14.79 0 1 1.06 0.94;
 12 1 6.1 1.6 0 0 1 1.055 -15.07 0 1 1.06 0.94;
 13 1 13.5 5.8 0 0 1 1.05 -15.16 0 1 1.06 0.94;
 14 1 14.9 5 0 0 1 1.036 -16.04 0 1 1.06 0.94;
];
mpc.gen = [
 1 232.4 -16.9 10 0 1.06 100 1 332.4 0;
 2 40 42.4 50 -40 1.045 100 1 140 0;
 3 0 23.4 40 0 1.01 100 1 100 0;
 6 0 12.2 24 -6 1.07 100 1 100 0;
 8 0 17.4 24 -6 1.09 100 1 100 0;
];
mpc.branch = [
 1 2 0.01938 0.05917 0.0528 0 0 0 0 0 1 -360 360;
 1 5 0.05403 0.22304 0.0492 0 0 0 0 0 1 -360 360;
 2 3 0.04699 0.19797 0.0438 0 0 0 0 0 1 -360 360;
 2 4 0.05811 0.17632 0.034 0 0 0 0 0 1 -360 360;
 2 5 0.05695 0.17388 0.0346 0 0 0 0 0 1 -360 360;
 3 4 0.06701 0.17103 0.0128 0 0 0 0 0 1 -360 360;
 4 5 0.01335 0.04211 0 0 0 0 0 0 1 -360 360;
 4 7 0 0.20912 0 0 0 0 0.978 0 1 -360 360;
 4 9 0 0.55618 0 0 0 0 0.969 0 1 -360 360;
 5 6 0 0.25202 0 0 0 0 0.932 0 1 -360 360;
 6 11 0.09498 0.1989 0 0 0 0 0 0 1 -360 360;
 6 12 0.12291 0.25581 0 0 0 0 0 0 1 -360 360;
 6 13 0.06615 0.13027 0 0 0 0 0 0 1 -360 360;
 7 8 0 0.17615 0 0 0 0 0 0 1 -360 360;
 7 9 0 0.11001 0 0 0 0 0 0 1 -360 360;
 9 10 0.03181 0.0845 0 0 0 0 0 0 1 -360 360;
 9 14 0.12711 0.27038 0 0 0 0 0 0 1 -360 360;
 10 11 0.08205 0.19207 0 0 0 0 0 0 1 -360 360;
 12 13 0.22092 0.19988 0 0 0 0 0 0 1 -360 360;
 13 14 0.17093 0.34802 0 0 0 0 0 0 1 -360 360;
];
"""


def _scenarios(grid, K):
    """(K, n) complex injections: the base case scaled per scenario, the
    scales 1 + 0.05 RandomState(0).randn(K)."""
    from csparse3_tpu_torch.models.powerflow import sbus

    scale = 1 + 0.05 * np.random.RandomState(0).randn(K)
    return sbus(grid)[None, :] * scale[:, None]


def _host_mismatch_sb(grid, Y, vm, va, sb):
    v = vm * np.exp(1j * va)
    mis = v * np.conj(Y.to_scipy().tocsr() @ v) - sb
    f = np.concatenate([mis.real[np.concatenate([grid.pv, grid.pq])],
                        mis.imag[grid.pq]])
    return float(np.abs(f).max())


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _study_line(name, seconds, scenarios, extra=""):
    log(f"studies[{name}]: wall_s={seconds:.3f} scenarios={scenarios} "
        f"scenarios_per_s={scenarios / seconds:.1f}" + extra)


def _without_branch(grid, k):
    keep = np.ones(grid.n_branch, dtype=bool)
    keep[k] = False
    return grid._replace(f=grid.f[keep], t=grid.t[keep], r=grid.r[keep],
                         x=grid.x[keep], b=grid.b[keep],
                         tap=np.asarray(grid.tap)[keep])


def _dc_oracle(grid, k):
    """Host DC flows of ``grid`` without branch ``k`` (scipy spsolve), or
    None when the reduced B' is singular."""
    import warnings

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from csparse3_tpu_torch.models.grids import SLACK

    n = grid.n_bus
    keep = np.flatnonzero(grid.bus_type != SLACK)
    P = (grid.pg - grid.pd)[keep]
    g2 = _without_branch(grid, k)
    b = 1.0 / g2.x
    B = sp.coo_matrix((np.concatenate([-b, -b, b, b]),
                       (np.concatenate([g2.f, g2.t, g2.f, g2.t]),
                        np.concatenate([g2.t, g2.f, g2.f, g2.t]))),
                      shape=(n, n)).tocsc()[keep][:, keep].tocsc()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        th_r = spla.spsolve(B, P)
    if not np.isfinite(th_r).all():
        return None
    th = np.zeros(n)
    th[keep] = th_r
    fl = (th[grid.f] - th[grid.t]) / grid.x
    fl[k] = 0.0
    return fl


def _islands(grid, k):
    """True when removing branch ``k`` cuts some bus off the slack (host,
    scipy.sparse.csgraph)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    g2 = _without_branch(grid, k)
    n = grid.n_bus
    adj = sp.coo_matrix((np.ones(g2.n_branch), (g2.f, g2.t)), shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    return bool((labels != labels[grid.slack[0]]).any())


def _batch_library_ms(A, xr, xi, dtype, reps=50):
    """Device ms of the one library call for the batched product: a
    torch.sparse CSR matrix of ``dtype`` times the dense (n, K) X, and of
    that call from the (K, n) parts xr, xi (X made by ``torch.complex`` and
    a transposing copy), for the records (used nowhere in the port), by
    queued CUDA events (late in the run torch.profiler drops records).
    Returns (ms, ms from the parts, the product)."""
    import torch

    lib = _csr_tensor(A, xr.device, dtype)

    def from_parts():
        return lib @ torch.complex(xr, xi).T.contiguous()

    X = torch.complex(xr, xi).T.contiguous()
    Y = lib @ X
    for _ in range(5):
        lib @ X
        from_parts()
    return (min(queued_ms(lambda: lib @ X, reps) for _ in range(2)),
            min(queued_ms(from_parts, reps) for _ in range(2)), Y)


def _share(rec):
    """The bound's share of the measured time, for the log."""
    return rec["bound_ms"] / rec["ms"] if rec["ms"] else 0.0


def _pair_record(xr, xi, dtype, replaces):
    """The copy kernel of ``scenario_minor_pairs`` on the (K, n) parts xr,
    xi: one launch, equal to its plain version (a stack of the transposed
    parts, itself one PyTorch call, so also ``library_ms``), queued ms of
    each beside the bound of reading the parts and writing the pairs once
    (no operations), and of the copy through a complex tensor
    (``complex_copy_ms``: ``torch.complex`` of the parts, transposed)."""
    import torch

    from csparse3_tpu_torch.kernels import bandpoints as kbp

    before = kbp.PAIR_LAUNCHES["scenario_minor_pairs"]
    got = kbp.scenario_minor_pairs(xr, xi, dtype)
    torch.cuda.synchronize()
    if kbp.PAIR_LAUNCHES["scenario_minor_pairs"] != before + 1:
        raise AssertionError("scenario_minor_pairs: not one launch")

    def plain():
        return torch.stack([xr.T.to(dtype), xi.T.to(dtype)], dim=-1)

    err = float((got - plain()).abs().max())
    if err != 0:
        raise AssertionError(f"scenario_minor_pairs: differs from the "
                             f"plain copy by {err}")

    def kernel():
        kbp.scenario_minor_pairs(xr, xi, dtype)

    def via_complex():  # the same layout, viewed as real
        return torch.view_as_real(torch.complex(
            xr.to(dtype), xi.to(dtype)).T.contiguous())

    if not torch.equal(via_complex(), got):
        raise AssertionError("scenario_minor_pairs: the complex copy "
                             "differs")
    for _ in range(5):
        kernel()
        plain()
        via_complex()
    t = [queued_ms(plain, 200), queued_ms(kernel, 200),
         queued_ms(kernel, 200), queued_ms(plain, 200)]
    nbytes = 2 * got.numel() * got.element_size()
    return dict(name="scenario_minor_pairs", route="cuda",
                source="csparse3_tpu_torch/csrc/bandpoints.cu",
                replaces=replaces, max_abs_err=err, ms=min(t[1], t[2]),
                plain_ms=min(t[0], t[3]), library_ms=min(t[0], t[3]),
                complex_copy_ms=queued_ms(via_complex, 200), turns=t,
                **bound_record(nbytes, 0))


def _k1_point(plan, Yh, K):
    """K1 at one batch size K on the 10k-bus Ybus (float32): one launch of
    the batched kernel (the one-vector kernel for K = 1) on its own input
    layout, against the plain version (within SPMV_REL of max|y|) and
    bit-equal to K one-vector launches; queued ms of that launch, of the
    whole call from (K, n) parts (copies included), of the plain version and
    of the library call (a complex64 CSR matrix times X (n, K)), beside the
    bound of the matrix as the plan holds it, x and y."""
    import torch

    from csparse3_tpu_torch.kernels.bandpoints import scenario_minor_pairs

    dev = plan.slabs.device
    n, m = plan.n, plan.m
    rng = np.random.RandomState(K)
    xr, xi = (torch.as_tensor(rng.rand(K, n).astype(np.float32), device=dev)
              for _ in range(2))
    if K == 1:
        x = torch.stack([xr[0], xi[0]])
        y = torch.empty((2, m), dtype=torch.float32, device=dev)

        def kernel():
            plan._launch(x, y)

        def whole():
            return plan(xr[0], xi[0])
    else:
        x = scenario_minor_pairs(xr, xi, torch.float32)
        y = torch.empty((2, K, m), dtype=torch.float32, device=dev)

        def kernel():
            plan._launch_batch(x, y)

        def whole():
            return plan(xr, xi)
    before = plan.kernel_launches, plan.scenario_launches
    kernel()
    torch.cuda.synchronize()
    if (plan.kernel_launches - before[0], plan.scenario_launches
            - before[1]) != (1, int(K >= 2)):
        raise AssertionError(f"K1 batch K={K}: not one launch of its kernel")
    yk = y.reshape(2, K, m)
    yp = torch.stack(plan.plain(xr, xi))
    scale = float(yp.abs().max())
    err = float((yk - yp).abs().max())
    single = all(torch.equal(torch.stack(plan(xr[k], xi[k])), yk[:, k])
                 for k in range(K))
    same = torch.equal(torch.stack(whole()).reshape(2, K, m), yk)
    if err > SPMV_REL * scale or not single or not same:
        raise AssertionError(f"K1 batch K={K}: err {err} over {scale}, "
                             f"bit-equal to single launches: {single}, the "
                             f"call from parts the same: {same}")

    def plain():
        plan.plain(xr, xi)

    for _ in range(10):
        kernel()
        whole()
    t = [queued_ms(plain, 20), queued_ms(kernel, 200),
         queued_ms(kernel, 200), queued_ms(plain, 20)]
    ms, plain_ms = min(t[1], t[2]), min(t[0], t[3])
    whole_ms = min(queued_ms(whole, 200) for _ in range(2))
    ptr, col, val = plan._kernel_lists()
    nbytes = sum(t_.numel() * t_.element_size() for t_ in (
        plan.slabs, plan.offs_t, ptr, col, val, x, y))
    flops = 8 * K * (plan.slabs[0].count_nonzero().item() + col.numel())
    lib_ms, lib_whole_ms, yl = _batch_library_ms(Yh, xr, xi, np.complex64)
    lerr = float(max((yl.real.T - yk[0]).abs().max(),
                     (yl.imag.T - yk[1]).abs().max()))
    if lerr > 4 * SPMV_REL * scale:
        raise AssertionError(f"K1 batch K={K}: library product disagrees: "
                             f"{lerr}")
    rec = dict(K=K, max_abs_err=err, ms=ms, whole_call_ms=whole_ms,
               ms_per_scenario=ms / K, plain_ms=plain_ms, library_ms=lib_ms,
               library_whole_call_ms=lib_whole_ms,
               bit_equal_to_single_launches=single,
               **bound_record(nbytes, flops))
    if K >= 2:
        rec["copy_of_x"] = _pair_record(
            xr, xi, torch.float32, "csparse3_tpu/kernels/bandpoints.py:546")
    log(f"studies: K1 K={K} (n={n}) float32: "
        f"{'batched' if K >= 2 else 'one-vector'} kernel device_ms={ms:.6f} "
        f"per_scenario_ms={ms / K:.6f} whole_call_from_parts_ms="
        f"{whole_ms:.6f} plain_ms={plain_ms:.6f} (queued; plain,kernel,"
        f"kernel,plain = {t}) library_csr_c64_@X_ms={lib_ms:.6f} (from "
        f"parts {lib_whole_ms:.6f}) bytes="
        f"{nbytes} bound_ms={rec['bound_ms']:.6f} ({rec['bound_by']}, "
        f"{_share(rec):.1%} reached) rel_err_vs_plain={err / scale:.3e} "
        + (f"copy_of_x_ms={rec['copy_of_x']['ms']:.6f} (plain stack "
           f"{rec['copy_of_x']['plain_ms']:.6f}, complex copy "
           f"{rec['copy_of_x']['complex_copy_ms']:.6f}, bound "
           f"{rec['copy_of_x']['bound_ms']:.6f}) " if K >= 2 else "") +
        f"bit_equal_to_{K}_single_launches={single}")
    return rec


def _k4_point(plan, Y, K):
    """K4 at one batch size K (float64, the 10k RCM Ybus, the plan's form):
    one launch of the batched split-complex kernel over the plan's batch
    entries on its scenario-minor x (n, K, 2) (the one-vector launch on an
    (n, 2) pair for K = 1), against the plain walk of the index row by row
    within the rounding bound of its sums and bit-equal to K one-vector
    launches, and the same bits from a (K, n, 2) input; queued ms of that
    launch, of the plan's whole call from (K, n) parts (the copy of x
    included), of the plain walk and of the library call (a complex128 CSR
    matrix times X (n, K)), beside the bound: for K = 1 the one-vector
    route's bytes (index, packed values, x, y), for a batch the bytes the
    function needs (the nonzeros, x, y: ``nonzero_bytes``; the batched
    kernel walks the nonzero entries and reads nothing of the route), with
    the route's bound kept beside it as ``route_bound_ms``."""
    import scipy.sparse as sp
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.kernels.bandpoints import scenario_minor_pairs

    re, im = plan.re, plan.im
    dev, n, m, sym = re.slabs.device, re.n, re.m, re.symmetric
    A = Y.to_scipy().tocsr()
    if sym:
        A = (sp.triu(A) + sp.triu(A, 1).T).tocsr()
    kmax = int(np.diff(A.indptr).max())
    rng = np.random.RandomState(K)
    xr, xi = (torch.as_tensor(rng.rand(K, n), device=dev) for _ in range(2))
    args = (re.omin, sym, re.runs, (re.run_values, im.run_values))
    if K == 1:
        x = torch.stack([xr[0], xi[0]], dim=-1)

        def kernel():
            return kdia.dia_split_cuda(re.slabs, im.slabs, x, *args)

        def whole():
            return plan(xr[0], xi[0])
    else:
        x = scenario_minor_pairs(xr, xi, torch.float64)
        entries = plan.batch_entries()

        def kernel():
            return kdia.dia_split_cuda(re.slabs, im.slabs, x, *args,
                                       scenario_minor=True, entries=entries)

        def whole():
            return plan(xr, xi)
    before = dict(kdia.LAUNCHES), dict(kdia.BATCH_LAUNCHES)
    y = kernel().reshape(K, 2, m)
    torch.cuda.synchronize()
    if any(kdia.LAUNCHES[k] != before[0][k] + 1 for k in before[0]) or (
            kdia.BATCH_LAUNCHES["dia_spmv_split_batched"]
            != before[1]["dia_spmv_split_batched"] + (K >= 2)):
        raise AssertionError(f"K4 batch K={K}: not one launch of its kernel")
    single = all(torch.equal(torch.stack(plan(xr[k], xi[k])), y[k])
                 for k in range(K))
    same = torch.equal(torch.stack(whole(), dim=-2).reshape(K, 2, m), y)
    if K >= 2:  # the wrapper's other batch layout
        same &= torch.equal(kdia.dia_split_cuda(
            re.slabs, im.slabs, torch.stack([xr, xi], dim=-1), *args,
            entries=entries), y)
    pr, pi = plan.plain(xr, xi)
    xa = (xr.abs() + xi.abs()).cpu().numpy()             # (K, n)
    bound = torch.as_tensor(2 * (kmax + 2) * 2.0 ** -53 * 1.01 * (
        (abs(A.real) + abs(A.imag)) @ xa.T).T, device=dev)
    tiny = torch.finfo(torch.float64).tiny
    worst = max(float(((y[:, 0] - pr).abs() / (bound + tiny)).max()),
                float(((y[:, 1] - pi).abs() / (bound + tiny)).max()))
    err = float(max((y[:, 0] - pr).abs().max(), (y[:, 1] - pi).abs().max()))
    if worst > 1 or not single or not same:
        raise AssertionError(f"K4 batch K={K}: worst row err over bound "
                             f"{worst}, bit-equal to single launches: "
                             f"{single}, the call from parts the same: "
                             f"{same}")

    def plain():
        plan.plain(xr, xi)

    for _ in range(10):
        kernel()
        whole()
    t = [queued_ms(plain, 5), queued_ms(kernel, 200), queued_ms(kernel, 200),
         queued_ms(plain, 5)]
    ms, plain_ms = min(t[1], t[2]), min(t[0], t[3])
    whole_ms = min(queued_ms(whole, 100) for _ in range(2))
    nbytes, listed, _ = run_route_bytes(plan, x, y)
    route_bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if K >= 2:
        nbytes = nonzero_bytes(re, im, x, y)[0]
    nnz = sum(int(p.slabs.count_nonzero()) * 2 - int(
        p.slabs[0].count_nonzero()) if sym else int(
            p.slabs.count_nonzero()) for p in (re, im))
    lib_ms, lib_whole_ms, yl = _batch_library_ms(A, xr, xi, np.complex128)
    lerr = float(max((yl.real.T - y[:, 0]).abs().max(),
                     (yl.imag.T - y[:, 1]).abs().max()))
    if lerr > 1e-12 * float(y.abs().max()):
        raise AssertionError(f"K4 batch K={K}: library product disagrees: "
                             f"{lerr}")
    rec = dict(K=K, form="symmetric" if sym else "general",
               max_abs_err=err, ms=ms, whole_call_ms=whole_ms,
               ms_per_scenario=ms / K, plain_ms=plain_ms, library_ms=lib_ms,
               library_whole_call_ms=lib_whole_ms,
               bit_equal_to_single_launches=single,
               **bound_record(nbytes, 2 * 2 * nnz * K, F64_FLOP_PER_S))
    if K >= 2:
        rec.update(batch_entries=int(plan.batch_entries()[1].numel()),
                   route_bound_ms=route_bound_ms, copy_of_x=_pair_record(
                       xr, xi, torch.float64,
                       "csparse3_tpu/kernels/dia_pallas.py:67"))
    log(f"studies: K4 K={K} (n={n}) float64 {rec['form']} form: "
        f"{'batched' if K >= 2 else 'one-vector'} kernel device_ms={ms:.6f} "
        f"per_scenario_ms={ms / K:.6f} whole_call_from_parts_ms="
        f"{whole_ms:.6f} runs_plain_ms={plain_ms:.6f} (queued; plain,kernel,"
        f"kernel,plain = {t}) library_csr_c128_@X_ms={lib_ms:.6f} (from "
        f"parts {lib_whole_ms:.6f}) bytes="
        f"{nbytes} ({listed} listed runs) bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {_share(rec):.1%} reached) "
        + (f"route_bound_ms={route_bound_ms:.6f} copy_of_x_ms="
           f"{rec['copy_of_x']['ms']:.6f} (plain stack "
           f"{rec['copy_of_x']['plain_ms']:.6f}, complex copy "
           f"{rec['copy_of_x']['complex_copy_ms']:.6f}, bound "
           f"{rec['copy_of_x']['bound_ms']:.6f}) " if K >= 2 else "") +
        f"worst_row_err_over_bound={worst:.4f} "
        f"bit_equal_to_{K}_single_launches={single}")
    return rec


def _batch_record(name, src, replaces, main, sweep):
    """The kernels line's record of a batched launch: the point at the
    studies' batch with every key of a kernel record, and the sweep."""
    return dict(name=name, route="cuda",
                source=f"csparse3_tpu_torch/csrc/{src}.cu",
                replaces=replaces, **main, sweep=sweep)


def studies_phase(dev):
    """The batched study path at 10k buses (synthetic_grid(10_000, seed=3),
    22,263 branches).  Returns (K1 launches, K4 launches, K1 batch record,
    K4 batch record); every check raises."""
    import warnings

    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch import (ACContingency, DCContingency,
                                    FastDecoupled, LinearContingency,
                                    NewtonPowerFlow, parse_case,
                                    short_circuit, zbus_columns)
    from csparse3_tpu_torch.kernels import bandpoints as kbp
    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.models.grids import (rcm_grid, synthetic_grid,
                                                 ybus)
    from csparse3_tpu_torch.models.powerflow import newton_raphson

    t_phase = time.perf_counter()
    g = synthetic_grid(N_SOLVE, seed=3)
    n, m = g.n_bus, g.n_branch

    # ---- (a) Newton 'bandpoints' / 'multifrontal', K load scenarios
    K = N_SCEN_NEWTON
    sb = _scenarios(g, K)
    pf = NewtonPowerFlow(g, spmv="bandpoints", solver="multifrontal",
                         tol=5e-5, device=dev)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pf.solve_batch(sb[:2])           # warm-up: first-use allocations
        pf._yplan.kernel_launches = pf._yplan.scenario_launches = 0
        kbp.PAIR_LAUNCHES["scenario_minor_pairs"] = 0
        (vm, va, it, res), secs = _timed(lambda: pf.solve_batch(sb))
        k1_launches = pf._yplan.kernel_launches
        k1_batched = pf._yplan.scenario_launches
        k1_pairs = kbp.PAIR_LAUNCHES["scenario_minor_pairs"]
    if _gate_engaged(caught):
        raise AssertionError("studies newton: the growth gate engaged")
    vm_h, va_h, it_h = vm.cpu().numpy(), va.cpu().numpy(), it.cpu().numpy()
    hm = [_host_mismatch_sb(g, pf.Y, vm_h[k], va_h[k], sb[k])
          for k in range(K)]
    diffs = []
    for k in range(4):
        vs, as_, its, rs, bad = pf.run(
            torch.as_tensor(g.vm0, dtype=torch.float64, device=dev),
            torch.zeros(n, dtype=torch.float64, device=dev),
            torch.as_tensor(sb[k].real.copy(), device=dev),
            torch.as_tensor(sb[k].imag.copy(), device=dev))
        diffs.append(max(float((vs - vm[k]).abs().max()),
                         float((as_ - va[k]).abs().max())))
    _study_line("newton_multifrontal_bandpoints", secs, K,
                f" iterations={sorted(set(it_h.tolist()))} max_residual="
                f"{float(res.max()):.3e} max_host_f64_mismatch={max(hm):.3e} "
                f"(bound {HOST_MISMATCH:.0e}) k1_launches={k1_launches} "
                f"(batched kernel {k1_batched}, copies of x {k1_pairs}) "
                f"(mismatch evaluations {int(it_h.max()) + 1}) "
                f"state_diff_vs_single_solves(4)={max(diffs):.3e}")
    if max(hm) > HOST_MISMATCH or (res > pf.tol).any():
        raise AssertionError("studies newton: a scenario did not converge")
    if not k1_launches == k1_batched == k1_pairs == int(it_h.max()) + 1:
        raise AssertionError(f"studies newton: {k1_launches} K1 launches "
                             f"({k1_batched} of the batched kernel, "
                             f"{k1_pairs} copies of x) "
                             f"for {int(it_h.max()) + 1} batched mismatch "
                             "evaluations")
    if max(diffs) > STATE_ATOL:
        raise AssertionError("studies newton: the batch disagrees with the "
                             "single solves")
    k1_sweep = [_k1_point(pf._yplan, pf.Y.to_scipy(), k)
                for k in K1_SWEEP]
    k1_rec = dict(next(r for r in k1_sweep if r["K"] == K),
                  launches=k1_batched)
    k1_rec["copy_of_x"] = dict(k1_rec["copy_of_x"], launches=k1_pairs)
    del pf, vm, va

    # ---- (b) fast-decoupled 'symdia' / 'blocklu', K load scenarios
    g_rcm = rcm_grid(g)[0]
    K = N_SCEN_FDPF
    sb = _scenarios(g_rcm, K)
    fd = FastDecoupled(g_rcm, spmv="symdia", solver="blocklu", device=dev)
    fd.solve_batch(sb[:2])
    for counts in (kdia.LAUNCHES, kdia.BATCH_LAUNCHES, kbp.PAIR_LAUNCHES):
        for key in counts:
            counts[key] = 0
    (vm, va, it), secs = _timed(lambda: fd.solve_batch(sb))
    sbr, sbi = (torch.as_tensor(np.ascontiguousarray(p), device=dev)
                for p in (sb.real, sb.imag))
    res = fd.residual(vm, va, sbr, sbi)
    k4_fdpf_pairs = kbp.PAIR_LAUNCHES["scenario_minor_pairs"]
    k4_fdpf = kdia.LAUNCHES["dia_spmv"]
    k4_fdpf_batched = kdia.BATCH_LAUNCHES["dia_spmv_split_batched"]
    its = int(it.max())
    worst = 0.0
    for k in range(K):
        v1, a1, i1 = fd.run(fd._vm0, torch.zeros_like(fd._vm0), sbr[k],
                            sbi[k])
        if i1 != int(it[k]):
            raise AssertionError(f"studies fdpf: scenario {k} took {i1} "
                                 f"iterations alone, {int(it[k])} batched")
        worst = max(worst, float((v1 - vm[k]).abs().max()),
                    float((a1 - va[k]).abs().max()))
    _study_line("fdpf_symdia_blocklu", secs, K,
                f" iterations={sorted(set(it.tolist()))} max_residual="
                f"{float(res.max()):.3e} k4_launches={k4_fdpf} (batched "
                f"kernel {k4_fdpf_batched}, copies of x {k4_fdpf_pairs}; 3 "
                f"it + 2 = {3 * its + 2}, with "
                "the batch's residual check) "
                f"max_state_diff_vs_{K}_single_solves={worst:.3e} (bound "
                f"{FDPF_BATCH_ATOL:.0e})")
    if (res > fd.tol).any() or worst > FDPF_BATCH_ATOL:
        raise AssertionError("studies fdpf: the batch did not converge or "
                             "disagrees with the single solves")
    if not k4_fdpf == k4_fdpf_batched == k4_fdpf_pairs == 3 * its + 2:
        raise AssertionError(f"studies fdpf: {k4_fdpf} K4 launches "
                             f"({k4_fdpf_batched} batched, {k4_fdpf_pairs} "
                             f"copies of x), not "
                             f"3 it + 2 = {3 * its + 2}")
    k4_sweep = [_k4_point(fd._yplan, fd.Y, k) for k in K4_SWEEP]
    del fd, vm, va

    # ---- (b') Newton 'dia' / 'blocklu', K load scenarios
    K = N_SCEN_BLOCKLU
    sb = sb[:K]
    pf = NewtonPowerFlow(g_rcm, spmv="dia", solver="blocklu", device=dev)
    pf.solve_batch(sb[:2])
    for counts in (kdia.LAUNCHES, kdia.BATCH_LAUNCHES, kbp.PAIR_LAUNCHES):
        for key in counts:
            counts[key] = 0
    (vm, va, it, res), secs = _timed(lambda: pf.solve_batch(sb))
    k4_newton = kdia.LAUNCHES["dia_spmv"]
    k4_newton_batched = kdia.BATCH_LAUNCHES["dia_spmv_split_batched"]
    k4_newton_pairs = kbp.PAIR_LAUNCHES["scenario_minor_pairs"]
    vm_h, va_h = vm.cpu().numpy(), va.cpu().numpy()
    hm = max(_host_mismatch_sb(g_rcm, pf.Y, vm_h[k], va_h[k], sb[k])
             for k in range(K))
    vs, as_, its1, _, _ = pf.run(
        torch.as_tensor(g_rcm.vm0, dtype=torch.float64, device=dev),
        torch.zeros(n, dtype=torch.float64, device=dev),
        torch.as_tensor(sb[0].real.copy(), device=dev),
        torch.as_tensor(sb[0].imag.copy(), device=dev))
    diff = max(float((vs - vm[0]).abs().max()),
               float((as_ - va[0]).abs().max()))
    _study_line("newton_dia_blocklu", secs, K,
                f" iterations={sorted(set(it.tolist()))} "
                f"max_host_f64_mismatch={hm:.3e} (bound "
                f"{DIA_HOST_MISMATCH:.0e}) k4_launches={k4_newton} "
                f"(batched kernel {k4_newton_batched}, copies of x "
                f"{k4_newton_pairs}) "
                f"(mismatch evaluations {int(it.max()) + 1}) "
                f"state_diff_vs_single_solve={diff:.3e}")
    if hm > DIA_HOST_MISMATCH or diff > DIA_STATE_ATOL or its1 != int(it[0]):
        raise AssertionError("studies newton blocklu: the batch disagrees")
    if not (k4_newton == k4_newton_batched == k4_newton_pairs
            == int(it.max()) + 1):
        raise AssertionError(f"studies newton blocklu: {k4_newton} K4 "
                             f"({k4_newton_batched} batched, "
                             f"{k4_newton_pairs} copies of x) "
                             "launches")
    # the general form at the Newton 'blocklu' batch's K
    k4_sweep.append(_k4_point(pf._yplan, pf.Y, K))
    k4_rec = dict(next(r for r in k4_sweep if r["K"] == N_SCEN_FDPF),
                  launches=k4_fdpf_batched + k4_newton_batched)
    k4_rec["copy_of_x"] = dict(k4_rec["copy_of_x"],
                               launches=k4_fdpf_pairs + k4_newton_pairs)
    del pf, vm, va

    # ---- (c) DC contingency over every branch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    dc = DCContingency(g, device=dev)
    rp = dc._rp
    # a scenario's working set: its fronts, its factors through the
    # refactorization and the retargeted solve plans, and its vectors
    per = 8 * (getattr(rp, "front_floats", 0) + 6 * (rp.lnz + rp.unz)
               + 4 * n + 3 * m)
    batch = int(max(1, min(m, STUDY_BYTES // per)))
    t_build = time.perf_counter() - t0
    dc.run(np.arange(2))
    (fl, th, ok), secs = _timed(lambda: dc.run(batch=batch))
    ok_h = ok.cpu().numpy()
    sample = np.random.RandomState(0).choice(m, N_SAMPLED, replace=False)
    worst = 0.0
    for k in sample:
        ref = _dc_oracle(g, k)
        if ref is None:
            continue
        if ok_h[k]:
            worst = max(worst, float(np.abs(fl[k].cpu().numpy() - ref).max()
                                     / max(np.abs(ref).max(), 1e-300)))
    flagged = np.flatnonzero(~ok_h)
    check = np.union1d(sample, flagged)
    islands = np.array([_islands(g, k) for k in check])
    ok_match = bool((ok_h[check] == ~islands).all())
    _study_line("dc_contingency", secs, m,
                f" batch={batch} plan={type(rp).__name__} build_s="
                f"{t_build:.3f} front_floats="
                f"{getattr(rp, 'front_floats', 0)} lnz={rp.lnz} "
                f"solve_levels=({rp._ltpl.nlevels}, {rp._utpl.nlevels}) "
                f"peak_device_GB="
                f"{torch.cuda.max_memory_allocated(dev) / 1e9:.1f} "
                f"islanding_outages={len(flagged)} "
                f"max_rel_flow_err_vs_spsolve({N_SAMPLED} sampled)="
                f"{worst:.3e} (bound {DC_FLOW_RTOL:.0e}) ok_equals_host_"
                f"islanding({len(check)} outages: the sample and every "
                f"flagged one)={ok_match}")
    if worst > DC_FLOW_RTOL or not ok_match:
        raise AssertionError("studies dc contingency disagrees with the "
                             "host")

    # ---- (d) LODF screening of every branch, against (c)
    def screen():
        lc = LinearContingency(g, device=dev)
        return lc, lc.run()

    (lc, (fl_l, ok_l)), secs = _timed(screen)
    both = (ok_l & ok).cpu().numpy()
    same_ok = bool(torch.equal(ok_l, ok))
    worst = 0.0
    for s in range(0, m, 2048):
        e = min(s + 2048, m)
        sel = torch.as_tensor(both[s:e], device=dev)
        d = (fl_l[s:e] - fl[s:e]).abs().amax(1)
        scale = fl[s:e].abs().amax(1).clamp_min(1e-300)
        if sel.any():
            worst = max(worst, float((d / scale)[sel].max()))
    _study_line("linear_contingency", secs, m,
                f" (ptdf {tuple(lc.H.shape)} + lodf + screening) "
                f"max_rel_flow_diff_vs_dc_contingency={worst:.3e} (bound "
                f"{DC_FLOW_RTOL:.0e}) ok_equal={same_ok}")
    if worst > DC_FLOW_RTOL or not same_ok:
        raise AssertionError("studies: LODF screening disagrees with the "
                             "DC contingency")
    del dc, fl, th, lc, fl_l

    # ---- (e) AC contingency, 'multifrontal'
    ks = np.random.RandomState(0).choice(m, N_AC_OUTAGES, replace=False)
    ac = ACContingency(g, solver="multifrontal", device=dev)
    ac.run(ks[:2])
    (vm, va, it, ok), secs = _timed(lambda: ac.run(ks, batch=AC_BATCH))
    ok_h = ok.cpu().numpy()
    worst, agree = 0.0, True
    for i in range(4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                vr, ar, _, rr = newton_raphson(_without_branch(g, ks[i]),
                                               tol=1e-8, device="cpu")
                conv = bool(rr < 1e-8)
            except (RuntimeError, ValueError, np.linalg.LinAlgError):
                conv = False
        agree &= conv == bool(ok_h[i])
        if conv and ok_h[i]:
            worst = max(worst, float(np.abs(vm[i].cpu().numpy() - vr).max()),
                        float(np.abs(va[i].cpu().numpy() - ar).max()))
    _study_line("ac_contingency_multifrontal", secs, len(ks),
                f" batch={AC_BATCH} converged={int(ok_h.sum())} "
                f"iterations={sorted(set(it.tolist()))} "
                f"state_diff_vs_host_newton(4)={worst:.3e} (bound "
                f"{AC_STATE_ATOL:.0e}) ok_equal={agree}")
    if not agree or worst > AC_STATE_ATOL:
        raise AssertionError("studies ac contingency disagrees with the "
                             "host Newton")
    del ac, vm, va

    # ---- (f) short circuit at every bus
    sc, secs = _timed(lambda: short_circuit(g, device=dev))
    Y = ybus(g)[0]
    b16 = np.random.RandomState(0).choice(n, 16, replace=False)
    Z = zbus_columns(Y, b16, device=dev).cpu().numpy()
    lu = spla.splu(Y.to_scipy().tocsc().astype(np.complex128))
    E = np.zeros((n, 16), dtype=np.complex128)
    E[b16, np.arange(16)] = 1
    Zs = lu.solve(E)
    zerr = float(np.abs(Z - Zs).max() / np.abs(Zs).max())
    ifs = sc.ifault[torch.as_tensor(b16, device=dev)].cpu().numpy()
    ierr = float(np.abs(ifs - 1 / Zs[b16, np.arange(16)]).max()
                 / np.abs(ifs).max())
    _study_line("short_circuit", secs, n,
                f" ok={int(sc.ok.sum())} z_columns(16)_rel_err_vs_scipy_splu"
                f"={zerr:.3e} ifault_rel_err={ierr:.3e} (bound "
                f"{Z_RTOL:.0e}) iflow={tuple(sc.iflow.shape)}")
    if zerr > Z_RTOL or ierr > Z_RTOL or not bool(sc.ok.all()):
        raise AssertionError("studies short circuit disagrees with scipy")
    del sc

    # ---- (g) MATPOWER text through Newton
    gp = parse_case(CASE14_TEXT)
    vm, va, it, res = NewtonPowerFlow(gp, device=dev).solve()
    hm = host_mismatch(gp, ybus(gp)[0], vm, va)
    log(f"studies[matpower]: parse_case(IEEE-14 text) buses={gp.n_bus} "
        f"branches={gp.n_branch} newton iterations={it} residual={res:.3e} "
        f"host_f64_mismatch={hm:.3e}")
    if hm > 1e-8:
        raise AssertionError("studies matpower: Newton on the parsed case")
    log(f"studies: phase seconds {time.perf_counter() - t_phase:.1f}")
    return (k1_launches, k4_fdpf + k4_newton,
            _batch_record("bandpoints_spmv_batched", "bandpoints",
                          "csparse3_tpu/kernels/bandpoints.py:546", k1_rec,
                          k1_sweep),
            _batch_record("dia_spmv_split_batched", "dia_spmv",
                          "csparse3_tpu/kernels/dia_pallas.py:67", k4_rec,
                          k4_sweep))


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
        launches += multifrontal_phase(dev, ell_state)
        dia_launches, band, band_ctx = banded_phase(dev, ell_state)
        blocklu_launches, _ = blocklu_phase(dev, band_ctx, ell_state)
        newton_case("ieee14", ieee14(), dev)
        k1_batch_launches, k4_batch_launches, k1_batch, k4_batch = \
            studies_phase(dev)
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
        # buses (K1; K2 is the same kernel); the launches counted are those
        # of the timed 10k Newton solves, solver='level' (one) and
        # 'multifrontal' (three); points_groups is the plan with
        # group_span=512 (K3's offset groups), one launch per call over the
        # groups' joined lists, equal to the default plan's result; its
        # library call is the same complex64 CSR product
        dict(record("bandpoints_spmv", "bandpoints",
                    "csparse3_tpu/kernels/bandpoints.py:546", launches,
                    k["default"]),
             cold_l2_ms=k["default"]["cold_l2_ms"],
             # the scenario axis: the batched kernel's one launch for the
             # K = 32 load scenarios at 10k buses (the batched Newton's
             # shape) on its scenario-minor x (n, K, 2); whole_call_ms is
             # the plan's call from (K, n) parts, the copy included; its
             # launches are those of the timed solve_batch (one per batched
             # mismatch evaluation); library_ms is the complex64 CSR matrix
             # times X (n, K); sweep: the same at each K of K1_SWEEP (K = 1
             # the one-vector launch)
             batch=k1_batch,
             points_groups=dict(
                 replaces="csparse3_tpu/kernels/bandpoints.py:266",
                 **{key: k["groups"][key] for key in (
                     "n_groups", "launches_per_call", "ms", "plain_ms",
                     "bound_ms", "bound_by", "library_ms", "abs_err")})),
        # the top-level numbers are one launch of the split-complex run
        # kernel at the shape the banded solves give it (float64, D=473,
        # n=10k, both real slab sets through the occupancy index they share,
        # x (n, 2)): the launches counted are those of the banded phase's
        # three solves and of the blocklu phase's three.  bound_ms
        # counts what the route moves: the listed runs (streamed whole, their
        # zeros included), the index, x and y; nonzero_bound_ms the nonzero
        # values, a position for each, x and y: the least any layout needs;
        # dense_bound_ms every slab value, as the dense kernel
        # (dense_kernel_ms, one launch per slab set on the raw slabs) reads
        # them.  plain_ms is the dense plain version, runs_plain_ms the plain
        # walk of the index; one_slab_set_ms is the run kernel on one slab
        # set and the stacked (2, n) input
        dict(record("dia_spmv", "dia_spmv",
                    "csparse3_tpu/kernels/dia_pallas.py:67",
                    dia_launches + blocklu_launches, band["dia"]),
             shape=f"float64 general form, both slab sets of the {N_SOLVE}"
                   "-bus RCM Ybus through their shared occupancy index, per "
                   "split-complex launch; library_ms is the complex128 CSR "
                   "product",
             **{k: band["dia"][k] for k in (
                 "runs_plain_ms", "one_slab_set_ms", "dense_kernel_ms",
                 "nonzero_bound_ms", "dense_bound_ms", "listed_runs",
                 "index_bytes")},
             symmetric_form=band["symdia"],
             # the scenario axis: the batched split-complex kernel's one
             # launch for K = 256 load scenarios, float64 symmetric form on
             # the 10k RCM Ybus (the batched fast-decoupled shape), on its
             # scenario-minor x (n, K, 2) and the plan's batch entries;
             # whole_call_ms is the plan's call from (K, n) parts, the copy
             # included; its launches are those of the timed FastDecoupled
             # and Newton 'blocklu' solve_batch calls; library_ms is the
             # complex128 CSR matrix times X (n, K); sweep: the symmetric
             # form at each K of K4_SWEEP (K = 1 the one-vector launch) and
             # the general form at the Newton 'blocklu' batch's K = 16
             batch=k4_batch,
             # per SplitDIA / SplitSymDIA call (1 launch) on the 200k-bus
             # RCM Ybus, float32; the library call is the complex64 CSR
             # product; two_launches_ms is one launch per slab set
             full_size_float32=dict(
                 shape=f"float32, both slab sets of the {N_KERNEL}-bus RCM "
                       "Ybus, per split-complex call of 1 launch",
                 launches_per_call=1, general_form=dia["dia"],
                 symmetric_form=dia["symdia"])),
        # the copy of a batch's (K, n) parts into the batched kernels'
        # scenario-minor (n, K, 2) layout (scenario_minor_pairs), which the
        # batched K1 and K4 launches read: the top-level numbers are one
        # launch at the fast-decoupled batch's shape (float64, K = 256, 10k
        # buses); its launches are those of the timed solve_batch calls (one
        # before each batched K1 or K4 launch); library_ms is the plain
        # stack of the transposed parts; float32_k32 is the Newton batch's
        dict(k4_batch["copy_of_x"],
             launches=(k1_batch["copy_of_x"]["launches"]
                       + k4_batch["copy_of_x"]["launches"]),
             float32_k32=k1_batch["copy_of_x"]),
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
