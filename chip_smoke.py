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
           NewtonPowerFlow(spmv='dia', solver='multifrontal') in float64
           must converge to 1e-10,
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
11. estimation: DC weighted-least-squares state estimation on
           synthetic_grid(10_000, seed=3): every branch flow and bus
           injection (32,263 measurements, 9,999 states) from the grid's DC
           state with seeded noise; ``dc_state_estimation(ordering='amd')``
           must give theta within 1e-8 of scipy's spsolve of the same normal
           equations and a finite chi2; with one flow corrupted by 20 sigma,
           ``largest_normalized_residual(chunk=1024)`` (32 LDL^T solves of
           (9999, 1024) right-hand sides on the card) must name it.  Seconds
           of the factor, the estimate and the sweep; fill; plan levels.
12. krylov: B + 3I of synthetic_grid(10_000, seed=1) in RCM order, float64:
           ``cg(SymDIAPlan, M=jacobi_prec)``, ``bicgstab(DIAPlan)``,
           ``gmres(DIAPlan, restart=30)`` to ||r|| <= 1e-12 ||b||, each x
           within 1e-8 of scipy's spsolve, and ``refine`` of a float32
           ``BandedLU`` with the float64 ``DIAPlan`` residual (2 sweeps) to
           1e-12; the DIA kernel launched once per matvec (counted); then
           the kernel alone at this shape against its plain version and
           scipy row by row, with its time, the plain version's, the
           library call's (float64 CSR @ x) and its bound.
13. ldlt:  ``ldlt(., 'amd')`` of B + 3I and of Ybus + a (1 - 1j) shunt
           (complex symmetric) at 10k buses: solves of 1 and 1024
           right-hand sides on the card within 1e-10 of scipy's splu; then
           ``btf_splu`` of the 10k Newton Jacobian: block count, a host
           solve within 1e-10 of scipy.
14. grad:  outside inference mode: gradients of sum(y^2) for ``spmv`` and
           ``SpMVPlan`` on real(Ybus) at 10k, float64 (x against A^T g from
           scipy within 1e-10, the values at 3 entries against central
           differences within 1e-5; the ELL padding zero), and of sum(x^2)
           for ``RefactorPlan`` / ``MultifrontalRefactor``
           ``.refactor(d)(b)`` on B + 3I at 3000 buses (b against scipy's
           spsolve(A^T, g), d at 3 entries against central differences),
           ``BandedLU`` and ``LDLTSolvePlan`` (b) and ``BandedRefactor`` (b
           and the values) on the RCM B + 3I at 10k.  Then the plans whose
           backward products run the hand kernels on transposed plans:
           ``DIAPlan``, ``SplitDIA`` and ``SplitSymDIA`` on the 10k RCM
           Ybus in float64 and ``SplitDIA`` on the 200k RCM Ybus in float32
           (K4: x and the slabs), ``SpGEMMPlan`` and ``GramPlan`` on the
           200k-bus connectivity matrix (K6: the values), ``BSR @ X`` with
           imag(Ybus) of 200k buses in (8, 128) blocks, X (n, 1024) (K5: X
           and the blocks).  Float32 gradients are held to scipy row by row
           within the rounding bound, and to central differences of the
           float64 plain product within 1e-3.  Each backward launch of K4,
           K5 and K6 is held to its plain version and timed beside it, its
           bound and its library call (K5 also on the block transpose's
           (128, 8) blocks); forward and backward seconds and device
           kernels of every case.
15. studies: the batched study path on synthetic_grid(10_000, seed=3)
           (22,263 branches), every scenario set made from RandomState(0):
           ``NewtonPowerFlow('bandpoints', 'multifrontal', tol=5e-5)
           .solve_batch`` of 32 load scenarios (host float64 mismatch of
           each <= 1e-4, 4 of them within 1e-4 of single solves, K1 once per
           batched mismatch evaluation); on the RCM-ordered grid
           ``FastDecoupled('symdia', 'blocklu').solve_batch`` of 256
           scenarios (each within 1e-6 of its single solve, with its
           iteration count; K4 3 it + 2 times with the batch's residual
           check) and ``NewtonPowerFlow('dia', 'blocklu').solve_batch`` of
           16; ``DCContingency`` over the first 4,000 of the 22,263 outages
           (batch printed; 32 sampled outages' flows within 1e-8 of scipy
           spsolve, ``ok`` equal to a host islanding check on those and on
           every flagged one); ``LinearContingency`` over all outages (on
           the DC sweep's outages the same flows within 1e-8 where neither
           islands, equal ``ok``); ``ACContingency(
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
16. spgemm: the sparse-product path on three matrices: C = Cf - Ct of
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
17. bsr:   the block product ``Y = A @ X``: the 16384^2 matrix of 32 x 32
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
18. islands (run after grad, before studies): the canonical GridCal flow
           at 1M buses (synthetic_grid(1_000_000, seed=0)), intact and
           with 30% of the branches out (kept where
           RandomState(0).rand(n_branch) > 0.3):
           ``LilMat`` bulk chunks -> C = Cf - Ct -> the branch graph
           A = C C^T and the bus graph C^T C -> ``islands`` and
           ``component_labels`` on the card, the labels equal to scipy's
           ``connected_components`` exactly (the intact grid one island
           each); rounds, wall seconds and the device ms of a round (queued
           CUDA events).  Then ``norm`` (1, inf, 'fro') of the last A on the
           card within 1e-12 of scipy; ``pack_4_by_4`` of the split-complex
           1M Ybus (re, -im; im, re) equal to scipy ``bmat``; an npz round
           trip of A (read back by the port and by scipy, equal) and of
           config 3's ``BandedLU`` stacks (the solve on the card after the
           load equal to the one before).
19. spike: BASELINE config 5: B' + 3I of the same grid (``from_triplets``,
           ``diags``, ``add``) in RCM order, ``StreamedSPIKE(A, P=8,
           ordering=None, s=2560)`` in float32 on the card; two solves (the
           first computes the tips and the reduced factor, the second keeps
           them) of RandomState(3) and (4) right-hand sides, each with a
           float64 host residual < 1e-4; wall seconds beside the operations'
           bound at the float32 peak, and the peak device memory.  Then a
           20k-bus system against the device ``BandedLU`` (float64) within
           1e-4 of max|x|.  Then config 5 distributed, on the same RCM
           B' + 3I once the StreamedSPIKE is freed, over
           ``Mesh.virtual(8, cuda:0)``: ``partition_rows`` and
           ``dist_spmv`` against scipy (1e-12 of max|y|), and
           ``DistBandedLU.factor_device(A, ordering=None, s=2560)`` in
           float32 (P = 8, m = 49): factor seconds, a first and a warm solve
           of the RandomState(3) right-hand side, each with a float64 host
           residual < 1e-4 and within 1e-4 of max|x| of the StreamedSPIKE
           solution, the peak device memory.
20. parallel (after spike): the distributed layer on
           ``Mesh.virtual(8, cuda:0)`` at the sizes of the JAX package's
           multi-device dry run: B' + 3I of synthetic_grid(100_000, seed=1)
           in RCM order: ``partition_rows`` must give a ring with k >= 1,
           its far-coupled variant k >= 2 and its random permutation the
           all-gather strategy, each ``dist_spmv`` within 1e-12 of scipy;
           the ring product's time beside the one-device ``spmv`` of the
           same matrix; BlockJacobi's 8 block plans built and applied
           under 'auto' and 'level' alone; ``dist_cg`` with
           ``BlockJacobi`` (tol 1e-6, residual < 1e-4), ``DiagJacobi``
           and no preconditioner (their iteration counts); the host-factored ``DistBandedLU`` at 100k;
           ``DistBandedLU.factor_device`` of the complex 25k system
           Ybus(synthetic_grid(25_000, seed=2)) + (3 + 0.5j) I;
           ``SchurLU(S=8).device_plan().dist_solve`` at 50k buses.  Each
           solve's float64 host residual < 1e-4.  In the studies phase,
           ``run_sharded`` of the DC, linear and AC studies over the same
           mesh against ``run`` on the same outages.

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
    """Run ``fn`` ``reps`` times under torch.profiler, recording the card's
    activity alone: the host's op records are not read, and turning them
    into events costs the host ~60 us each (tens of seconds after a solve
    of 86k launches).  Returns (wall s, device-busy s as the union of
    kernel intervals, kernel launches, {kernel name: (count, device s)})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    # 'multifrontal', a depth cut: the 'level' refactor build on the RCM
    # Jacobian took 68.5 s, so the RCM-ordered Newton 'level' solve is no
    # longer driven (Newton 'level' runs on the natural order in the newton
    # phase, K4 under 'level' through FastDecoupled below)
    pf = NewtonPowerFlow(g, spmv="dia", solver="multifrontal", device=dev)
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
    ``refactor``; with float64, the gradient through the factorization
    (``_factor_grad``).  Returns {dtype: record} (and "grad")."""
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
    if "float64" in dtypes:
        out["grad"] = _factor_grad(name, plan, A, dev)
    return out


# the gradients through the factorizations (float64) against the exact
# gradient of another route: refactor(d)(b)'s -lam[rows] x[cols], scipy's
FACTOR_GRAD_RTOL = 1e-8


def _backward_memory(fwd, inputs):
    """(bytes the forward keeps, bytes the backward adds over the forward's
    peak): the peak statistics reset before one forward, its peak read,
    then the backward's."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    loss = fwd()
    torch.cuda.synchronize()
    f_peak = torch.cuda.max_memory_allocated()
    kept = torch.cuda.memory_allocated() - base
    torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    return kept, torch.cuda.max_memory_allocated() - f_peak


def _spread_entries(g, count=3):
    """The entry of largest |g| in each of ``count`` equal parts of g: the
    central differences' relative gap needs a gradient well above the
    loss's rounding."""
    parts = np.array_split(np.arange(g.numel()), count)
    a = g.detach().abs().cpu().numpy()
    return [int(p[np.argmax(a[p])]) for p in parts]


def _factor_grad(name, plan, A, dev):
    """The gradient through ``plan``'s factorization, float64, outside
    inference mode: Σ retarget_solve_plan(p, *p.factor_values(d))(b)² in d
    and b (the reverse sweep over the saved factors, then ``_FactorSolve``)
    against the same loss through ``p.refactor(d)(b)`` (``_Solve``), each
    within FACTOR_GRAD_RTOL of its largest entry; a weighted loss on (Lx,
    Ux) by central differences at 3 entries; the chain's forward and
    backward seconds and device kernels, and the device memory its
    backward adds over the forward's peak."""
    import torch

    from csparse3_tpu_torch.linalg import retarget_solve_plan

    data = A.np_arrays()[2]
    rng = np.random.RandomState(11)
    with torch.inference_mode(False):
        d = torch.tensor(data, dtype=torch.float64, device=dev,
                         requires_grad=True)
        b = torch.tensor(rng.rand(A.n), device=dev, requires_grad=True)

        def chain():
            Lx, Ux = plan.factor_values(d)
            return (retarget_solve_plan(plan, Lx, Ux)(b) ** 2).sum()

        ref = torch.autograd.grad((plan.refactor(d)(b) ** 2).sum(), (d, b))
        (gd, gb), times = _timed_grad(chain, (d, b))
        errs = [_rel_err(g, r.cpu().numpy()) for g, r in zip((gd, gb), ref)]
        kept, added = _backward_memory(chain, (d, b))
        _grad_log(f"factor:{name}", times, None,
                  f" d_err_over_max_vs_refactor={errs[0]:.3e} "
                  f"b_err_over_max_vs_refactor={errs[1]:.3e} (limit "
                  f"{FACTOR_GRAD_RTOL:.0e}) forward_kept_MB="
                  f"{kept / 2**20:.1f} backward_added_MB={added / 2**20:.1f}")
        if not max(errs) <= FACTOR_GRAD_RTOL:
            raise AssertionError(f"grad[factor:{name}]: the chain's gradient "
                                 "disagrees with refactor's")
        wL = torch.tensor(rng.randn(plan.lnz), device=dev)
        wU = torch.tensor(rng.randn(plan.unz), device=dev)

        def weighted():
            Lx, Ux = plan.factor_values(d)
            return (wL * Lx).sum() + (wU * Ux).sum()

        gw, = torch.autograd.grad(weighted(), d)
        _fd_check(f"factor:{name}", weighted, d, gw, _spread_entries(gw),
                  "solve")
    return {"forward_s": times[0], "backward_s": times[1],
            "forward_kernels": times[2], "backward_kernels": times[3],
            "errs": errs, "forward_kept_bytes": kept,
            "backward_added_bytes": added}


def _multifrontal_lu_grad(dev):
    """``MultifrontalLU.from_matrix(refactor_system(N_SOLVE))``: Σ
    solve_piv(factor_piv(d), b)² in d and b, float64, outside inference
    mode; b's gradient against scipy's spsolve(A^T, 2x) and d's against
    -lam[rows] x[cols] with that lam, each within FACTOR_GRAD_RTOL of its
    largest entry; the forward's and backward's seconds and kernels, the
    backward's added memory, and how many fronts' pivot orders are not the
    identity."""
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch.linalg import MultifrontalLU

    A = refactor_system(N_SOLVE)
    t0 = time.perf_counter()
    lu = MultifrontalLU.from_matrix(A, device=dev)
    t_build = time.perf_counter() - t0
    S = A.to_scipy().tocsc()
    ip, ix, data = A.np_arrays()
    bnp = np.random.RandomState(12).rand(A.n)
    xs = spla.spsolve(S, bnp)
    lam = spla.spsolve(S.T.tocsc(), 2 * xs)
    gd_ref = -lam[np.asarray(ix)] * xs[np.repeat(np.arange(A.n),
                                                 np.diff(ip))]
    with torch.inference_mode(False):
        d = torch.tensor(data, dtype=torch.float64, device=dev,
                         requires_grad=True)
        b = torch.tensor(bnp, device=dev, requires_grad=True)

        def loss():
            factors, _ = lu.factor_piv(d)
            return (lu.solve_piv(factors, b) ** 2).sum()

        (gd, gb), times = _timed_grad(loss, (d, b))
        errs = (_rel_err(gd, gd_ref), _rel_err(gb, lam))
        kept, added = _backward_memory(loss, (d, b))
    factors, _ = lu.factor_piv(d.detach())
    moved = sum(int((f[3] != torch.arange(f[3].shape[-1], device=dev))
                    .any(-1).sum()) for f in factors)
    _grad_log("MultifrontalLU", times, None,
              f" d_err_over_max_vs_scipy={errs[0]:.3e} "
              f"b_err_over_max_vs_scipy={errs[1]:.3e} (limit "
              f"{FACTOR_GRAD_RTOL:.0e}) forward_kept_MB={kept / 2**20:.1f} "
              f"backward_added_MB={added / 2**20:.1f} build_s={t_build:.3f} "
              f"fronts={lu.nsnodes} fronts_with_row_swaps={moved}")
    if not max(errs) <= FACTOR_GRAD_RTOL:
        raise AssertionError("grad[MultifrontalLU]: the gradient disagrees "
                             "with scipy's adjoint")


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
    from csparse3_tpu_torch.utils import profiling

    t_phase = time.perf_counter()
    grid = synthetic_grid(N_SOLVE, seed=3)
    t0 = time.perf_counter()
    with profiling.Timer() as setup:
        pf = NewtonPowerFlow(grid, spmv="bandpoints", solver="multifrontal",
                             tol=5e-5, device=dev)
    t_build = time.perf_counter() - t0
    t_symbolic = sum(setup.records["setup.symbolic"])
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
        f"(symbolic_s={t_symbolic:.3f}: generic splu and fronts) "
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
    _multifrontal_lu_grad(dev)

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
# DC contingency outages swept: the first 4,000 branches of 22,263 (the
# sweep is launch-bound, so its scenarios/s holds on a prefix; the whole
# sweep took 60-91 s of the script's 1200 s limit)
N_DC_OUTAGES = 4000
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

    # ---- (c) DC contingency over the first N_DC_OUTAGES branches
    n_dc = min(N_DC_OUTAGES, m)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    dc = DCContingency(g, device=dev)
    rp = dc._rp
    # a scenario's working set: its fronts, its factors through the
    # refactorization and the retargeted solve plans, and its vectors
    per = 8 * (getattr(rp, "front_floats", 0) + 6 * (rp.lnz + rp.unz)
               + 4 * n + 3 * m)
    batch = int(max(1, min(n_dc, STUDY_BYTES // per)))
    t_build = time.perf_counter() - t0
    dc.run(np.arange(2))
    (fl, th, ok), secs = _timed(lambda: dc.run(np.arange(n_dc), batch=batch))
    ok_h = ok.cpu().numpy()
    sample = np.random.RandomState(0).choice(n_dc, N_SAMPLED, replace=False)
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
    _study_line("dc_contingency", secs, n_dc,
                f" outages=the first {n_dc} of {m} batch={batch} plan="
                f"{type(rp).__name__} build_s="
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

    # ---- (d) LODF screening of every branch, against (c) on its outages
    def screen():
        lc = LinearContingency(g, device=dev)
        return lc, lc.run()

    (lc, (fl_l, ok_l)), secs = _timed(screen)
    fl_l, ok_l = fl_l[:n_dc], ok_l[:n_dc]
    both = (ok_l & ok).cpu().numpy()
    same_ok = bool(torch.equal(ok_l, ok))
    worst = 0.0
    for s in range(0, n_dc, 2048):
        e = min(s + 2048, n_dc)
        sel = torch.as_tensor(both[s:e], device=dev)
        d = (fl_l[s:e] - fl[s:e]).abs().amax(1)
        scale = fl[s:e].abs().amax(1).clamp_min(1e-300)
        if sel.any():
            worst = max(worst, float((d / scale)[sel].max()))
    _study_line("linear_contingency", secs, m,
                f" (ptdf {tuple(lc.H.shape)} + lodf + screening) "
                f"max_rel_flow_diff_vs_dc_contingency(first {n_dc} "
                f"outages)={worst:.3e} (bound "
                f"{DC_FLOW_RTOL:.0e}) ok_equal={same_ok}")
    if worst > DC_FLOW_RTOL or not same_ok:
        raise AssertionError("studies: LODF screening disagrees with the "
                             "DC contingency")
    from csparse3_tpu_torch.parallel import Mesh

    mesh = Mesh.virtual(MESH_S, dev)
    ks_sh = np.arange(N_SHARDED)
    _sharded_check("dc", dc, mesh, ks_sh)
    _sharded_check("linear", lc, mesh, ks_sh)
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
    _sharded_check("ac", ac, mesh, ks[:N_SHARDED_AC])
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


# ---------------------------------------------------------------------------
# the symmetric and Krylov solvers, DC state estimation and the gradients
# ---------------------------------------------------------------------------

# estimation: every branch flow (sigma 0.01) and bus injection (sigma 0.02)
# of synthetic_grid(10_000, seed=3) from its DC state with seeded noise; one
# flow corrupted by 20 sigma must come out as the suspect
SE_SIGMA_FLOW, SE_SIGMA_INJ = 0.01, 0.02
SE_BAD = 4321
SE_CHUNK = 1024
# theta against scipy's spsolve of the same normal equations (both float64
# direct solves of a gain matrix of condition ~1e6 here)
SE_THETA_ATOL = 1e-8
# Krylov: stop at ||r|| <= 1e-12 ||b||; x within 1e-8 of scipy's spsolve
# over max|x| (cond(B + 3I) is some 1e2-1e3); refinement of a float32
# factor with a float64 residual, two sweeps, to 1e-12 (one sweep gives
# 5e-15 in the JAX package's docstring)
KRYLOV_TOL = 1e-12
KRYLOV_RTOL = 1e-8
REFINE_RTOL = 1e-12
GMRES_RESTART = 30
# LDL^T solves (float64 and complex128) against scipy's splu, over max|x|
LDLT_RTOL = 1e-10
# gradients: exact products against scipy within 1e-10 of the largest
# entry; central differences within 1e-5.  The product's loss sum(y^2) is
# quadratic in each value, so its central difference is exact at any step
# and a step of 1e-2 (relative to the entry) keeps the rounding of the
# 1e8-sized loss out of the difference; the solve's loss takes the JAX
# package's test's step, 1e-6
GRAD_RTOL = 1e-10
GRAD_FD_RTOL = 1e-5
# a float32 gradient against central differences of the float64 loss of
# the same values: the float32 product's rounding, relative to an output
# that cancels (Ybus rows sum to ~0), reaches ~1e-4 of the gradient
GRAD_FD_RTOL_F32 = 1e-3
GRAD_FD_STEP = {"product": 1e-2, "solve": 1e-6}
# buses of the B + 3I system of the refactor-solve gradients: its level and
# front plans build ~14x faster than at N_SOLVE (host build, measured on a
# CPU), and the gradients' checks do not depend on the size
N_GRAD_SOLVE = 3_000


def _rel_err(x, ref):
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def estimation_phase(dev):
    """DC weighted-least-squares state estimation at 10k buses (M = 32,263
    measurements, 9,999 states): the estimate against scipy's solve of the
    same normal equations, then bad-data identification of one flow
    corrupted by 20 sigma (``largest_normalized_residual``: ceil(M / 1024)
    solves of (9999, 1024) right-hand sides on the card)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch.models import estimation
    from csparse3_tpu_torch.models.estimation import (
        DCMeasurements, dc_state_estimation, largest_normalized_residual)
    from csparse3_tpu_torch.models.grids import synthetic_grid
    from csparse3_tpu_torch.models.powerflow import dc_power_flow

    t_phase = time.perf_counter()
    g = synthetic_grid(N_SOLVE, seed=3)
    th = dc_power_flow(g, device=dev)
    flows = (th[g.f] - th[g.t]) / g.x
    inj = np.zeros(g.n_bus)
    np.add.at(inj, g.f, flows)
    np.add.at(inj, g.t, -flows)
    rng = np.random.RandomState(0)
    zf = flows + SE_SIGMA_FLOW * rng.randn(g.n_branch)
    zi = inj + SE_SIGMA_INJ * rng.randn(g.n_bus)

    def measurements(zf):
        return DCMeasurements.build(
            flows=(np.arange(g.n_branch), zf, SE_SIGMA_FLOW),
            injections=(np.arange(g.n_bus), zi, SE_SIGMA_INJ))

    meas = measurements(zf)
    # the factor's seconds, timed inside the one estimate: the module's
    # ldlt wrapped for this call
    factor_s, ldlt = [], estimation.ldlt

    def timed_ldlt(*args, **kw):
        t = time.perf_counter()
        f = ldlt(*args, **kw)
        factor_s.append(time.perf_counter() - t)
        return f

    estimation.ldlt = timed_ldlt
    try:
        t0 = time.perf_counter()
        res = dc_state_estimation(g, meas, ordering="amd")
        t_est = time.perf_counter() - t0
    finally:
        estimation.ldlt = ldlt
    H = res.H.to_scipy().tocsc()
    z = np.concatenate([meas.flow_val, meas.inj_val])
    G = (H.T @ sp.diags(res.weights) @ H).tocsc()
    th_ref = spla.spsolve(G, H.T @ (res.weights * z))
    err = float(np.abs(res.theta[res.keep] - th_ref).max())
    log(f"estimation: buses={g.n_bus} measurements={meas.size} "
        f"states={len(res.keep)} dof={res.dof} chi2={res.chi2:.6e} "
        f"gain_nnz={res.G.nnz} fill_nnz={res.factor.fill_nnz} "
        f"factor_s={sum(factor_s):.3f} estimate_s={t_est:.3f} theta_max_err_vs_scipy={err:.3e} "
        f"bound={SE_THETA_ATOL:.0e}")
    if not (err <= SE_THETA_ATOL and np.isfinite(res.chi2)):
        raise AssertionError("estimation: the estimate disagrees with scipy")

    zb = zf.copy()
    zb[SE_BAD] += 20 * SE_SIGMA_FLOW
    bad = dc_state_estimation(g, measurements(zb), ordering="amd")
    t0 = time.perf_counter()
    plan = bad.factor.solve_plan(device=dev)
    t_plan = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    j, rN = largest_normalized_residual(bad, chunk=SE_CHUNK, device=dev)
    torch.cuda.synchronize()
    t_sweep = time.perf_counter() - t0
    chunks = -(-bad.H.shape[0] // SE_CHUNK)
    second = float(np.sort(rN)[-2])
    log(f"estimation: bad data at flow {SE_BAD} (+20 sigma): j_max={j} "
        f"rN[j_max]={rN[j]:.3f} next_largest_rN={second:.3f} "
        f"sweep_s={t_sweep:.3f} ({chunks} solves of ({len(bad.keep)}, "
        f"{SE_CHUNK}) on the card) solve_plan_build_s={t_plan:.3f} "
        f"ldlt_plan_levels=({plan.lplan.nlevels}, {plan.ltplan.nlevels}) "
        f"sweeps={type(plan.lplan).__name__}")
    if j != SE_BAD or not np.isfinite(rN).all():
        raise AssertionError(f"estimation: the suspect is {j}, not {SE_BAD}")
    log(f"estimation: phase seconds {time.perf_counter() - t_phase:.1f}")


def _b3i_rcm():
    """B + 3I of synthetic_grid(10_000, seed=1) (``refactor_system``) in RCM
    order, its scipy form and a seeded right-hand side."""
    from csparse3_tpu_torch.linalg.ordering import rcm
    from csparse3_tpu_torch.ops.slicing import submatrix

    A0 = refactor_system(N_SOLVE)
    perm = rcm(A0)
    A = submatrix(A0, perm, perm)
    return A, A.to_scipy().tocsc(), np.random.RandomState(5).rand(N_SOLVE)


def _krylov_k4_record(dev, plans, S):
    """K4 alone at the Krylov matvec's shape (float64, one vector): each
    plan's launch against its plain version and scipy row by row within the
    rounding bound (``main_shape_records``' bound with u = 2^-53); queued
    ms of the general plan's launch, of its plain version and of the
    library call (torch.sparse CSR float64 @ x), beside its bound: the
    bytes the function needs (the nonzero values, an int32 position each,
    x and y), the route's bound (the listed runs streamed whole, zeros
    included, and the index) kept as ``route_bound_ms``."""
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.utils.roofline import plan_bytes

    x = torch.rand(N_SOLVE, dtype=torch.float64, device=dev)
    xh = x.cpu().numpy()
    kmax = int(np.diff(S.tocsr().indptr).max())
    bound = torch.as_tensor(2 * (kmax + 2) * 2.0 ** -53 * 1.01
                            * (abs(S) @ np.abs(xh)), device=dev)
    tiny = torch.finfo(torch.float64).tiny
    ys = torch.as_tensor(S @ xh, device=dev)
    err = 0.0
    saved = dict(kdia.LAUNCHES)
    for label, plan in plans.items():
        yk, yp = plan(x), plan.plain(x)
        worst = max(float(((yk - want).abs() / (bound + tiny)).max())
                    for want in (yp, ys))
        err = max(err, float((yk - yp).abs().max()))
        log(f"krylov: K4[{label}] float64 slabs={tuple(plan.slabs.shape)} "
            f"runs={plan.has_runs} run_share={plan.run_share:.5f} "
            f"max_abs_err_vs_plain={float((yk - yp).abs().max()):.3e} "
            f"worst_row_err_over_bound={worst:.4f} (kmax={kmax}; must be "
            f"<= 1) bit_equal_on_repeat={torch.equal(plan(x), yk)}")
        if worst > 1 or not torch.equal(plan(x), yk):
            raise AssertionError(f"krylov: K4[{label}] disagrees")
    gen = plans["general"]
    csr = S.tocsr()
    Ad = torch.sparse_csr_tensor(
        torch.as_tensor(csr.indptr.astype(np.int64), device=dev),
        torch.as_tensor(csr.indices.astype(np.int64), device=dev),
        torch.as_tensor(csr.data, device=dev), size=csr.shape)
    if float(((Ad @ x - ys).abs() / (bound + tiny)).max()) > 1:
        raise AssertionError("krylov: the library product disagrees")
    nz_bytes = (int(gen.slabs.count_nonzero()) * (gen.slabs.element_size()
                                                  + 4)
                + 2 * x.numel() * x.element_size())
    rec = dict(
        shape=f"float64 general form, B + 3I of the {N_SOLVE}-bus grid in "
              "RCM order, one vector per launch (the Krylov and refinement "
              "matvecs); library_ms is the float64 CSR product",
        max_abs_err=err, ms=queued_ms(lambda: gen(x), 200),
        plain_ms=queued_ms(lambda: gen.plain(x), 20, spin_ms=2 * 20 * wall_ms(
            lambda: gen.plain(x), 3)),
        library_ms=queued_ms(lambda: Ad @ x, 200),
        nonzero_bytes=nz_bytes,
        route_bound_ms=plan_bytes(gen, x, x) / HBM_BYTES_PER_S * 1e3,
        **bound_record(nz_bytes, 2 * S.nnz, F64_FLOP_PER_S))
    kdia.LAUNCHES.update(saved)  # the comparisons count no launch
    return rec


def krylov_phase(dev):
    """cg / bicgstab / gmres(restart=30) and mixed-precision refinement on
    B + 3I of the 10k grid in RCM order, float64, with K4 (``SymDIAPlan``
    for cg, ``DIAPlan`` for the others) as the matvec: x against scipy's
    spsolve, the residual under its bound, K4's launches per solver (one per
    matvec), then K4 alone against its plain version.  Returns (K4 launches
    of the four solves, record)."""
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.linalg import (BandedLU, bicgstab, cg, gmres,
                                           jacobi_prec, refine)
    from csparse3_tpu_torch.ops.matvec import DIAPlan, SymDIAPlan

    import scipy.sparse.linalg as spla

    t_phase = time.perf_counter()
    A, S, b = _b3i_rcm()
    xr = spla.spsolve(S, b)
    bt = torch.as_tensor(b, device=dev)
    sym, gen = SymDIAPlan(A, device=dev), DIAPlan(A, device=dev)
    M = jacobi_prec(A, device=dev)
    lu32 = BandedLU(A, ordering=None, dtype=np.float32, device=dev)
    m = GMRES_RESTART
    solvers = {
        # (call, expected K4 launches for `it` iterations)
        "cg": (lambda: cg(sym, bt, M=M, tol=KRYLOV_TOL, maxiter=5000),
               lambda it: 1 + it),
        "bicgstab": (lambda: bicgstab(gen, bt, tol=KRYLOV_TOL,
                                      maxiter=5000), lambda it: 1 + 2 * it),
        "gmres": (lambda: gmres(gen, bt, tol=KRYLOV_TOL, restart=m,
                                maxiter=200), lambda it: 1 + it * (m + 2)),
        "refine": (lambda: (refine(lu32, gen, bt, iters=2), None, 2),
                   lambda it: it),
    }
    for call, _ in solvers.values():
        call()  # warm-up: first-use allocations and library handles
    out = {}
    for key in kdia.LAUNCHES:
        kdia.LAUNCHES[key] = 0
    for name, (call, expect) in solvers.items():
        before = kdia.LAUNCHES["dia_spmv"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, res, it = call()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = kdia.LAUNCHES["dia_spmv"] - before
        xh = x.cpu().numpy()
        err = _rel_err(xh, xr)
        rres = float(np.linalg.norm(b - S @ xh) / np.linalg.norm(b))
        limit = REFINE_RTOL if name == "refine" else KRYLOV_RTOL
        out[name] = dict(iterations=it, seconds=secs, launches=launches,
                         rel_err=err, rel_residual=rres)
        log(f"krylov[{name}]: iterations={it} seconds={secs:.4f} "
            f"k4_launches={launches} (expected {expect(it)}) "
            f"x_err_over_max_vs_scipy={err:.3e} (limit {limit:.0e}) "
            f"rel_residual={rres:.3e}" + (
                "" if res is None else f" solver_residual={float(res):.3e}"))
        if launches != expect(it) or not err <= limit:
            raise AssertionError(f"krylov[{name}]: failed")
        if res is not None and not (float(res) <= KRYLOV_TOL
                                    * np.linalg.norm(b) and it > 0):
            raise AssertionError(f"krylov[{name}]: did not converge")
    launches = kdia.LAUNCHES["dia_spmv"]
    if kdia.LAUNCHES["dia_spmv_runs"] not in (0, launches) or launches != sum(
            r["launches"] for r in out.values()):
        raise AssertionError(f"krylov: launches {kdia.LAUNCHES}")
    # what binds cg: its device-busy share against the host's loop (one
    # read of the stop test per iteration)
    wall, busy, nk, by = device_profile(solvers["cg"][0], 1)
    k4 = sum(t for name, (c, t) in by.items() if "dia" in name.lower())
    out["cg"].update(profiled_wall_s=wall, device_busy_s=busy,
                     idle_share=1 - busy / wall, k4_device_s=k4)
    log(f"krylov[cg]: profiled solve wall_s={wall:.4f} device_busy_s="
        f"{busy:.4f} idle_share={1 - busy / wall:.4f} kernels={nk} "
        f"k4_device_s={k4:.6f}")
    rec = _krylov_k4_record(dev, {"symmetric": sym, "general": gen}, S)
    rec.update(launches=launches, solvers=out)
    log(f"krylov: K4 launch {rec['ms']:.6f} ms plain {rec['plain_ms']:.6f} "
        f"ms library {rec['library_ms']:.6f} ms bound {rec['bound_ms']:.6f} "
        f"ms ({rec['bound_by']}; {rec['nonzero_bytes']} bytes) route bound "
        f"{rec['route_bound_ms']:.6f} ms; phase seconds "
        f"{time.perf_counter() - t_phase:.1f}")
    return launches, rec


def ldlt_phase(dev):
    """``ldlt(., 'amd')`` of B + 3I and of Ybus + a shunt (complex
    symmetric) at 10k buses: solves of 1 and 1024 right-hand sides on the
    card against scipy's splu; then ``btf_splu`` of the 10k Newton Jacobian
    at a perturbed flat start (host), a solve against scipy."""
    import scipy.sparse.linalg as spla
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.linalg import btf_splu, ldlt
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus
    from csparse3_tpu_torch.models.powerflow import _jacobian

    t_phase = time.perf_counter()
    g = synthetic_grid(N_SOLVE, seed=3)
    Y, _, _ = ybus(g)
    n = g.n_bus
    shunt = pt.from_triplets(np.arange(n), np.arange(n),
                             np.full(n, 1.0 - 1.0j), (n, n))
    rng = np.random.RandomState(7)
    for label, M in (("bprime", refactor_system(N_SOLVE)),
                     ("ybus", Y + shunt)):
        cplx = label == "ybus"
        t0 = time.perf_counter()
        f = ldlt(M, ordering="amd")
        t_factor = time.perf_counter() - t0
        t0 = time.perf_counter()
        plan = f.solve_plan(device=dev)
        t_plan = time.perf_counter() - t0
        B = rng.rand(n, N_RHS) + (1j * rng.rand(n, N_RHS) if cplx else 0)
        Bt = torch.as_tensor(B, device=dev)
        plan(Bt[:, 0])
        plan(Bt)  # warm-up: first-use allocations
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x1 = plan(Bt[:, 0])
        torch.cuda.synchronize()
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        X = plan(Bt)
        torch.cuda.synchronize()
        tk = time.perf_counter() - t0
        ref = spla.splu(M.to_scipy().tocsc()).solve(B)
        e1, ek = _rel_err(x1, ref[:, 0]), _rel_err(X, ref)
        log(f"ldlt[{label}]: n={n} {'complex128' if cplx else 'float64'} "
            f"nnz={M.nnz} fill_nnz={f.fill_nnz} factor_s={t_factor:.3f} "
            f"plan_build_s={t_plan:.3f} levels=({plan.lplan.nlevels}, "
            f"{plan.ltplan.nlevels}) sweeps={type(plan.lplan).__name__} "
            f"solve_1rhs_s={t1:.4f} solve_{N_RHS}rhs_s={tk:.4f} "
            f"err_over_max_vs_scipy=({e1:.3e}, {ek:.3e}) "
            f"(limit {LDLT_RTOL:.0e})")
        if f.is_singular or not max(e1, ek) <= LDLT_RTOL:
            raise AssertionError(f"ldlt[{label}]: failed")

    # BTF of the Newton Jacobian (host): its block count and a solve
    v = g.vm0 * np.exp(1j * 0.01 * np.random.RandomState(8).randn(n))
    ibus = Y.to_scipy().tocsr() @ v
    J = _jacobian(Y, v, ibus, np.concatenate([g.pv, g.pq]), g.pq)
    t0 = time.perf_counter()
    blu = btf_splu(J)
    t_btf = time.perf_counter() - t0
    b = rng.rand(J.n)
    t0 = time.perf_counter()
    x = blu.solve(b)
    t_solve = time.perf_counter() - t0
    err = _rel_err(x, spla.spsolve(J.to_scipy().tocsc(), b))
    sizes = np.diff(blu.blocks)
    log(f"ldlt: btf_splu of the {n}-bus Newton Jacobian (dim {J.n}, nnz "
        f"{J.nnz}): blocks={blu.nblocks} largest={int(sizes.max())} "
        f"fill={blu.fill} factor_s={t_btf:.3f} host_solve_s={t_solve:.3f} "
        f"err_over_max_vs_scipy={err:.3e} (limit {LDLT_RTOL:.0e})")
    if blu.is_singular or not err <= LDLT_RTOL:
        raise AssertionError("ldlt: btf_splu solve failed")
    log(f"ldlt: phase seconds {time.perf_counter() - t_phase:.1f}")


def _fd_check(label, loss, values, grad, ks, kind, rtol=GRAD_FD_RTOL):
    """Central differences of ``loss`` in ``values[k]`` for each k of ``ks``
    (a step of GRAD_FD_STEP[kind] relative to the entry) against
    ``grad[k]``, within ``rtol``."""
    import torch

    worst = 0.0
    for k in ks:
        h = GRAD_FD_STEP[kind] * max(1.0, abs(float(values[k].detach())))
        with torch.no_grad():
            old = values[k].clone()
            values[k] = old + h
            up = float(loss())
            values[k] = old - h
            dn = float(loss())
            values[k] = old
        fd, an = (up - dn) / (2 * h), float(grad[k])
        worst = max(worst, abs(an - fd) / max(abs(fd), 1e-300))
    log(f"grad[{label}]: central differences at entries {list(ks)} "
        f"(gradient {[float(grad[k]) for k in ks]}): worst relative gap "
        f"{worst:.3e} (limit {rtol:.0e})")
    if not worst <= rtol:
        raise AssertionError(f"grad[{label}]: the gradient disagrees with "
                             "central differences")


#: launches of the hand kernels made by the timed backward passes of the
#: grad phase (``_timed_grad``): the counts set to 0 just before each
#: backward and read just after it, then added here
BACKWARD_LAUNCHES = {"dia_spmv": 0, "spgemm_numeric": 0, "bsr_spmm": 0}


def _kernel_counts():
    from csparse3_tpu_torch.kernels import bsr_spmm as kbsr
    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.kernels import spgemm as kspg

    return {"dia_spmv": kdia.LAUNCHES, "spgemm_numeric": kspg.LAUNCHES,
            "bsr_spmm": kbsr.LAUNCHES}


def _timed_grad(fwd, inputs):
    """(grads, (forward s, backward s, forward kernels, backward kernels)):
    one forward and one backward, each timed by the host clock to a
    synchronize, then each once more under torch.profiler for its count of
    device kernels.  One untimed forward and backward go first (lazily
    loaded kernels, the allocator's first blocks).  The launches of the hand
    kernels in the timed backward go to ``BACKWARD_LAUNCHES`` (the last of
    them in ``_timed_grad.last``)."""
    import torch

    torch.autograd.grad(fwd(), inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = fwd()
    torch.cuda.synchronize()
    t_f = time.perf_counter() - t0
    counts = _kernel_counts()
    for name, c in counts.items():
        c[name] = 0
    t0 = time.perf_counter()
    grads = torch.autograd.grad(loss, inputs)
    torch.cuda.synchronize()
    t_b = time.perf_counter() - t0
    _timed_grad.last = {name: c[name] for name, c in counts.items()}
    for name, k in _timed_grad.last.items():
        BACKWARD_LAUNCHES[name] += k
    _, _, k_f, _ = device_profile(fwd, 1)
    again = fwd()
    _, _, k_b, _ = device_profile(
        lambda: torch.autograd.grad(again, inputs), 1)
    return grads, (t_f, t_b, k_f, k_b)


def grad_phase(dev):
    """Gradients on the card, float64, outside inference mode: ``spmv`` and
    ``SpMVPlan`` on the real part of the 10k Ybus (with respect to x against
    A^T g from scipy, to the values at 3 entries against central
    differences), and ``RefactorPlan`` / ``MultifrontalRefactor``
    ``.refactor(d)(b)`` on B + 3I at 3000 buses (with respect to b against scipy's
    spsolve(A^T, g), to d at 3 entries against central differences).  Prints
    the backward's seconds and device kernels beside the forward's."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.linalg import (MultifrontalRefactor, RefactorPlan,
                                           splu)
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus

    if torch.is_inference_mode_enabled():
        raise AssertionError("grad phase: runs outside inference mode")
    t_phase = time.perf_counter()
    Y, _, _ = ybus(synthetic_grid(N_SOLVE, seed=3))
    ip, ix, yv = Y.np_arrays()
    vals = np.ascontiguousarray(yv.real)
    n = Y.n
    S = sp.csc_matrix((vals, ix, ip), shape=(n, n))
    x = np.random.RandomState(9).randn(n)
    gx_ref = S.T @ (2 * (S @ x))
    ks = (0, len(vals) // 2, len(vals) - 1)

    # eager spmv: values and x both differentiable
    d = torch.tensor(vals, device=dev, requires_grad=True)
    xt = torch.tensor(x, device=dev, requires_grad=True)
    A = pt.CSC(n, n, torch.as_tensor(ip, device=dev),
               torch.as_tensor(ix, device=dev), d)

    def spmv_loss():
        return (pt.spmv(A, xt) ** 2).sum()

    (gd, gx), times = _timed_grad(spmv_loss, (d, xt))
    _grad_log("spmv", times, _rel_err(gx, gx_ref))
    _fd_check("spmv", spmv_loss, d, gd, ks, "product")

    # SpMVPlan (ELL): its values buffer and x
    plan = pt.SpMVPlan(pt.CSC(n, n, ip, ix, vals), device=dev)
    plan.vals.requires_grad_()

    def plan_loss():
        return (plan(xt) ** 2).sum()

    (gv, gx), times = _timed_grad(plan_loss, (plan.vals, xt))
    _grad_log("SpMVPlan", times, _rel_err(gx, gx_ref))
    live = torch.nonzero(plan.live_slots().reshape(-1))[:, 0]
    flat_v, flat_g = plan.vals.view(-1), gv.reshape(-1)
    if flat_g[~plan.live_slots().reshape(-1)].abs().max() != 0:
        raise AssertionError("grad[SpMVPlan]: a padded slot has a gradient")
    _fd_check("SpMVPlan", plan_loss, flat_v, flat_g,
              [int(live[i]) for i in (0, len(live) // 2, len(live) - 1)],
              "product")

    # refactor-and-solve: RefactorPlan and MultifrontalRefactor on B + 3I
    A = refactor_system(N_GRAD_SOLVE)
    Sa = A.to_scipy().tocsc()
    data = A.np_arrays()[2]
    bnp = np.random.RandomState(10).rand(N_GRAD_SOLVE)
    xs = spla.spsolve(Sa, bnp)
    gb_ref = spla.spsolve(Sa.T.tocsc(), 2 * xs)
    t0 = time.perf_counter()
    lu = splu(A, ordering="nd", tol=0.0)
    plans = {"RefactorPlan": RefactorPlan(lu._h, A, device=dev),
             "MultifrontalRefactor": MultifrontalRefactor(lu._h, A,
                                                          device=dev)}
    log(f"grad: B + 3I plans built in {time.perf_counter() - t0:.1f} s")
    ks = (0, len(data) // 2, len(data) - 1)
    for label, rp in plans.items():
        d = torch.tensor(data, device=dev, requires_grad=True)
        b = torch.tensor(bnp, device=dev, requires_grad=True)

        def solve_loss():
            return (rp.refactor(d)(b) ** 2).sum()

        # the first backward builds the transposed level templates
        t0 = time.perf_counter()
        torch.autograd.grad(solve_loss(), (d, b))
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        (gd, gb), times = _timed_grad(solve_loss, (d, b))
        _grad_log(label, times, _rel_err(gb, gb_ref),
                  f" first_call_with_templates_s={t_first:.3f}")
        _fd_check(label, solve_loss, d, gd, ks, "solve")
    del plans, lu
    t0 = time.perf_counter()
    _grad_solve_cases(dev)
    log(f"grad: banded and LDL^T cases seconds {time.perf_counter() - t0:.1f}")

    # the plans that run K4, K5 and K6: their backward products run the
    # same kernels on the transposed plans
    t0 = time.perf_counter()
    g200 = synthetic_grid(N_KERNEL, seed=0)
    Y0, _, _ = ybus(g200)
    log(f"grad: synthetic_grid({N_KERNEL}, seed=0) and its Ybus in "
        f"{time.perf_counter() - t0:.1f} s")
    for key in BACKWARD_LAUNCHES:
        BACKWARD_LAUNCHES[key] = 0
    out = {}
    for key, case, arg in (("dia_spmv", _grad_band_cases, Y0),
                           ("spgemm_numeric", _grad_spgemm_cases, g200),
                           ("bsr_spmm", _grad_bsr_case, Y0)):
        t0 = time.perf_counter()
        out[key] = case(dev, arg)
        torch.cuda.empty_cache()
        log(f"grad: {key} backward cases seconds "
            f"{time.perf_counter() - t0:.1f}")
    for key, rec in out.items():
        rec["launches"] = BACKWARD_LAUNCHES[key]
        if not rec["launches"]:
            raise AssertionError(f"grad: no backward launched {key}")
    torch.cuda.empty_cache()
    log(f"grad: backward launches of the hand kernels {BACKWARD_LAUNCHES}; "
        f"phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


def _grad_log(label, times, err, extra=""):
    """Log a gradient's times and kernels, and hold ``err`` (its error over
    the largest entry against scipy; None where ``extra`` holds the check)
    to GRAD_RTOL."""
    t_f, t_b, k_f, k_b = times
    check = "" if err is None else (
        f" exact_grad_err_over_max_vs_scipy={err:.3e} (limit "
        f"{GRAD_RTOL:.0e})")
    log(f"grad[{label}]: forward_s={t_f:.4f} backward_s={t_b:.4f} "
        f"forward_kernels={k_f} backward_kernels={k_b}{check}{extra}")
    if err is not None and not err <= GRAD_RTOL:
        raise AssertionError(f"grad[{label}]: the gradient disagrees with "
                             "scipy")


def _pair(re, im):
    """The two real plans of an adjoint pair as one module (for
    ``plan_bytes``, ``run_route_bytes``)."""
    from torch import nn

    m = nn.Module()
    m.re, m.im = re, im
    return m


def _row_ratio(got, ref, bound):
    """max_i |got_i - ref_i| / bound_i for tensors on one device."""
    import torch

    tiny = torch.finfo(torch.float64).tiny
    return float(((got.double() - ref.double()).abs()
                  / (bound.double() + tiny)).max())


def _rows_bound(S, v, u, dev):
    """The row-wise rounding bound (k + 2) u (|S| |v|) of a product S v
    (k the longest row of S), as a tensor on ``dev``."""
    import torch

    S = S.tocsr()
    k = int(np.diff(S.indptr).max())
    return torch.as_tensor((k + 2) * u * 1.01 * (abs(S) @ np.abs(v)),
                           device=dev)


def _time_pair(kernel, plain, reps, plain_reps):
    """(kernel ms, plain ms): queued device ms, runs plain, kernel, kernel,
    plain on one card."""
    for _ in range(3):
        kernel()
    t = [queued_ms(plain, plain_reps), queued_ms(kernel, reps),
         queued_ms(kernel, reps), queued_ms(plain, plain_reps)]
    return min(t[1], t[2]), min(t[0], t[3])


def _lib_ms(fn, reps=20):
    """Device ms of one library call (torch.profiler's busy time)."""
    for _ in range(3):
        fn()
    _, busy, _, _ = device_profile(fn, reps)
    return busy / reps * 1e3


def _band_backward_record(label, adj, g2, S_adj, dev, u, rate, cdtype):
    """K4 as a split band's backward launches it: one launch of the
    split-complex run kernel over the adjoint pair ``adj`` = (re, im,
    shared) on g = (gr, gi) (``g2`` (2, n)), held row by row to its plain
    walk and to scipy's A^H g (``S_adj``) within the rounding bound; its
    time beside the plain walk's, its route bound and the library call
    (torch.sparse CSR of A^H times g)."""
    import torch

    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.ops.matvec import _split_apply

    re, im, shared = adj
    if not shared:
        raise AssertionError(f"grad[{label}]: the adjoint pair shares no "
                             "index")
    sym, gn2 = re.symmetric, g2.T.contiguous()
    vals = (re.run_values, im.run_values)

    def kernel():
        return kdia.dia_split_cuda(re.slabs, im.slabs, gn2, re.omin, sym,
                                   re.runs, vals)

    def plain():
        return torch.stack(_split_apply(re, im, True, g2[0], g2[1],
                                        plain=True))

    before = kdia.LAUNCHES["dia_spmv"]
    yk = kernel()
    yp = plain()
    if kdia.LAUNCHES["dia_spmv"] != before + 1:
        raise AssertionError(f"grad[{label}]: not one launch")
    gh = g2.double().cpu().numpy()
    z = S_adj @ (gh[0] + 1j * gh[1])
    A = S_adj.tocsr()
    bound = _rows_bound(abs(A.real) + abs(A.imag), np.abs(gh).sum(0), u,
                        dev)
    zt = torch.as_tensor(np.stack([z.real, z.imag]), device=dev)
    ratios = {"vs_runs_plain": _row_ratio(yk, yp, 2 * bound),
              "vs_scipy": _row_ratio(yk, zt, bound)}
    err = float((yk - yp).abs().max())
    ms, plain_ms = _time_pair(kernel, plain, 200, 5)
    lib = _csr_tensor(S_adj, dev, cdtype)
    gc = torch.complex(g2[0], g2[1])
    lib_ms = _lib_ms(lambda: lib @ gc)
    nbytes, listed, _ = run_route_bytes(_pair(re, im), gn2, yk)
    nnz = sum(int(p.slabs.count_nonzero()) * 2 - int(
        p.slabs[0].count_nonzero()) if sym else int(
            p.slabs.count_nonzero()) for p in (re, im))
    rec = dict(launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=lib_ms, listed_runs=listed, bytes=nbytes,
               **bound_record(nbytes, 2 * 2 * nnz, rate))
    log(f"grad[{label}]: backward K4 launch on the adjoint pair "
        f"(A_r^T, -A_i^T; {listed} listed runs, one shared index): "
        f"max_abs_err_vs_plain={err:.3e} worst_row_err_over_bound: "
        + " ".join(f"{k}={v:.4f}" for k, v in ratios.items())
        + f" (bound (k+2) u |A||g| per row, twice that against the plain "
        f"walk; must be <= 1) kernel_device_ms={ms:.6f} "
        f"runs_plain_device_ms={plain_ms:.6f} bound_ms="
        f"{rec['bound_ms']:.6f} ({rec['bound_by']}, {nbytes} bytes) "
        f"share_of_bound={rec['bound_ms'] / ms:.4f} "
        f"library_csr_A^H_g_device_ms={lib_ms:.6f}")
    if not all(v <= 1 for v in ratios.values()):
        raise AssertionError(f"grad[{label}]: the backward launch disagrees")
    return rec


def _nonzero_entries(t, count=3):
    """``count`` flat indices of nonzero entries of ``t``, spread over it:
    entries the forward reads (a packed run, a listed column)."""
    import torch

    nz = torch.nonzero(t.detach().reshape(-1))[:, 0].cpu().numpy()
    return [int(nz[i]) for i in np.linspace(0, len(nz) - 1, count).astype(
        int)]


def _grad_band_cases(dev, Y0):
    """K4 backward: ``DIAPlan``, ``SplitDIA`` and ``SplitSymDIA`` on the
    10k RCM Ybus in float64 (the banded solves' shape), ``SplitDIA`` on the
    RCM order of ``Y0``, the 200k-bus Ybus, in float32.  Returns the
    backward record (10k ``SplitDIA``'s launch at the top, the others under
    their names)."""
    import scipy.sparse as sp
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.kernels import dia as kdia
    from csparse3_tpu_torch.linalg.ordering import rcm
    from csparse3_tpu_torch.models.grids import (rcm_grid, synthetic_grid,
                                                 ybus)

    Y10, _, _ = ybus(rcm_grid(synthetic_grid(N_SOLVE, seed=3))[0])
    n = Y10.n
    ip, ix, yv = Y10.np_arrays()
    rng = np.random.RandomState(12)
    u64 = 2.0 ** -53

    # DIAPlan on real(Ybus): slabs and x
    Sr = sp.csc_matrix((yv.real, ix, ip), shape=(n, n))
    plan = pt.DIAPlan(pt.CSC(n, n, ip, ix, yv.real.copy()), device=dev)
    plan.slabs.requires_grad_()
    x = torch.tensor(rng.randn(n), device=dev, requires_grad=True)

    def dia_loss():
        return (plan(x) ** 2).sum()

    plan.transposed()  # built once, outside the timed backward
    (gs, gx), times = _timed_grad(dia_loss, (plan.slabs, x))
    if _timed_grad.last["dia_spmv"] != 1:
        raise AssertionError(f"grad[DIAPlan]: backward launches "
                             f"{_timed_grad.last}, not one K4 launch")
    xh = x.detach().cpu().numpy()
    _grad_log("DIAPlan 10k f64", times,
              _rel_err(gx, Sr.T @ (2 * (Sr @ xh))))
    _fd_check("DIAPlan 10k f64", lambda: (plan.plain(x) ** 2).sum(),
              plan.slabs.view(-1), gs.reshape(-1),
              _nonzero_entries(plan.slabs), "product")
    t = plan.transposed()
    g1 = (2 * plan(x)).detach()[None]
    yk, yp = t.apply_bn(g1), t.apply_bn(g1, plain=True)
    one = dict(launches=_timed_grad.last["dia_spmv"],
               max_abs_err=float((yk - yp).abs().max()))
    one["ms"], one["plain_ms"] = _time_pair(
        lambda: t.apply_bn(g1), lambda: t.apply_bn(g1, plain=True), 200, 5)
    log(f"grad[DIAPlan 10k f64]: backward K4 launch on the transposed plan "
        f"(one slab set, {sum(r.numel() for r in t.runs[1::2])} listed "
        f"runs): max_abs_err_vs_plain={one['max_abs_err']:.3e} "
        f"kernel_device_ms={one['ms']:.6f} runs_plain_device_ms="
        f"{one['plain_ms']:.6f}")
    if one["max_abs_err"] > 1e-12 * float(yp.abs().max()):
        raise AssertionError("grad[DIAPlan]: the transposed launch disagrees")
    del plan, t, gs
    out = {"DIAPlan": one}

    def split_case(label, plan, Y, u, rate, fd_rtol, cdtype):
        """x and both slab sets of the split ``plan`` for sum(yr^2 + yi^2),
        dx against scipy 2 A^H y, the slabs at 3 nonzeros against central
        differences of the float64 plain product, and the record of the
        backward launch."""
        m = Y.n
        for p in (plan.re, plan.im):
            p.slabs.requires_grad_()
        dtype = plan.re.slabs.dtype
        xr = torch.tensor(rng.randn(m), dtype=dtype, device=dev,
                          requires_grad=True)
        xi = torch.tensor(rng.randn(m), dtype=dtype, device=dev,
                          requires_grad=True)

        def loss():
            yr, yi = plan(xr, xi)
            return (yr ** 2).sum() + (yi ** 2).sum()

        t0 = time.perf_counter()
        plan.adjoint()  # built once, outside the timed backward
        log(f"grad[{label}]: adjoint pair (transposed slabs, index, packed "
            f"runs) built in {time.perf_counter() - t0:.1f} s")
        grads, times = _timed_grad(
            loss, (plan.re.slabs, plan.im.slabs, xr, xi))
        if _timed_grad.last["dia_spmv"] != 1:
            raise AssertionError(f"grad[{label}]: backward launches "
                                 f"{_timed_grad.last}, not one K4 launch")
        S = Y.to_scipy().tocsc()
        if plan.re.symmetric:
            S = (sp.triu(S) + sp.triu(S, 1).T).tocsc()
        SH = S.conj().T.tocsc()
        with torch.no_grad():
            y2 = torch.stack(plan(xr, xi))
        yh = y2.double().cpu().numpy()
        ref = SH @ (2 * (yh[0] + 1j * yh[1]))
        dx = torch.stack(grads[2:])
        bound = _rows_bound(abs(SH.real) + abs(SH.imag),
                            2 * np.abs(yh).sum(0), u, dev)
        ratio = _row_ratio(dx, torch.as_tensor(np.stack(
            [ref.real, ref.imag]), device=dev), bound)
        _grad_log(label, times, None, f" dx_worst_row_err_over_bound_vs_"
                  f"scipy_2A^H_y={ratio:.4f} (bound (k+2) u |A||g| per row; "
                  f"must be <= 1)")
        if not ratio <= 1:
            raise AssertionError(f"grad[{label}]: dx disagrees with scipy")
        re, im = plan.re, plan.im

        def loss64():
            # the plain walk of the same runs in float64, on the slabs as
            # they are now: the product the gradient is of, without the
            # float32 rounding of the loss
            x64 = (xr.detach().double(), xi.detach().double())
            yr, yi = kdia.split_complex_apply(
                *(functools.partial(kdia.dia_spmv_runs_plain,
                                    p.slabs.detach().double(), omin=p.omin,
                                    symmetric=p.symmetric, runs=p.runs)
                  for p in (re, im)), *x64)
            return float((yr ** 2).sum() + (yi ** 2).sum())

        _fd_check(label, loss64, re.slabs.view(-1), grads[0].reshape(-1),
                  _nonzero_entries(re.slabs), "product", fd_rtol)
        g2 = (2 * y2).to(dtype)
        rec = _band_backward_record(label, plan.adjoint(), g2, SH, dev, u,
                                    rate, cdtype)
        rec["launches"] = _timed_grad.last["dia_spmv"]
        return rec

    Y10c = pt.CSC(n, n, ip, ix, yv)
    for cls in (pt.SplitDIA, pt.SplitSymDIA):
        out[cls.__name__] = split_case(
            f"{cls.__name__} 10k f64", cls(Y10c, device=dev), Y10c, u64,
            F64_FLOP_PER_S, GRAD_FD_RTOL, np.complex128)
    torch.cuda.empty_cache()

    # SplitDIA on the 200k RCM Ybus, float32 (the dia phase's matrix)
    t0 = time.perf_counter()
    perm = rcm(Y0)
    Yp = Y0[perm, perm]
    ip2, ix2, dt2 = Yp.np_arrays()
    Y200 = pt.CSC(Yp.m, Yp.n, ip2, ix2, dt2.astype(np.complex64))
    plan = pt.SplitDIA(Y200, device=dev)
    log(f"grad[SplitDIA 200k f32]: RCM and plan build seconds "
        f"{time.perf_counter() - t0:.1f}")
    big = split_case("SplitDIA 200k f32", plan, Y200, 2.0 ** -24,
                     F32_FLOP_PER_S, GRAD_FD_RTOL_F32, np.complex64)
    del plan
    torch.cuda.empty_cache()
    return dict(out["SplitDIA"], full_size_float32=big,
                symmetric_form=out["SplitSymDIA"],
                transposed_one_slab_set=out["DIAPlan"])


def _on_pattern(M, rows, cols):
    """The entries of the scipy matrix M at (rows, cols), as a vector."""
    return np.asarray(M.tocsr()[rows, cols]).ravel()


def _grad_spgemm_cases(dev, grid):
    """K6 backward on the connectivity matrix C of ``grid`` (200k buses),
    float32: ``SpGEMMPlan`` of C @ C^T (the gradients of both value arrays)
    and ``GramPlan`` of C C^T, each gradient two launches of the kernel over
    the products sorted by entry; against scipy's G B^T and A^T G on the
    operands' patterns, row by row within the rounding bound, and central
    differences of the float64 plain pass.  Returns the backward record of
    the launch that gives dA."""
    import scipy.sparse as sp
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.kernels import spgemm as kspg
    from csparse3_tpu_torch.models.grids import connectivity

    u = 2.0 ** -24
    Cf, Ct = connectivity(grid)
    C = Cf - Ct
    CT = C.T
    rng = np.random.RandomState(13)
    ipa, ixa, _ = C.np_arrays()
    ipb, ixb, _ = CT.np_arrays()
    a_np = rng.randn(C.nnz).astype(np.float32)
    b_np = rng.randn(CT.nnz).astype(np.float32)
    t0 = time.perf_counter()
    plan = pt.spgemm_symbolic(C, CT, device=dev)
    gplan = pt.gram_symbolic(C, device=dev)
    maps = [plan.grad_maps(side, nv) for side, nv in ((0, C.nnz),
                                                      (1, CT.nnz))]
    gplan.grad_maps(0, C.nnz)
    gplan.grad_maps(1, C.nnz)
    log(f"grad[SpGEMMPlan conn200k f32]: symbolic phases and the maps by "
        f"entry built in {time.perf_counter() - t0:.1f} s; {plan.n_products} "
        f"products, {C.nnz} entries of A, {plan.out_nnz} outputs")
    a = torch.tensor(a_np, device=dev, requires_grad=True)
    b = torch.tensor(b_np, device=dev, requires_grad=True)
    w = torch.tensor(rng.rand(plan.out_nnz).astype(np.float32), device=dev)
    wg = torch.tensor(rng.rand(gplan.out_nnz).astype(np.float32), device=dev)

    def loss():
        return (w * plan.numeric(a, b).data ** 2).sum()

    def gram_loss():
        return (wg * gplan.numeric(a).data ** 2).sum()

    (ga, gb), times = _timed_grad(loss, (a, b))
    if _timed_grad.last["spgemm_numeric"] != 2:
        raise AssertionError(f"grad[SpGEMMPlan]: backward launches "
                             f"{_timed_grad.last}, not two K6 launches")
    # scipy: G = dL/dC on C's pattern, dA = G B^T and dB = A^T G on the
    # operands' patterns; bound (L + 1) u (|G| |B|^T) per entry, L the
    # products of the longest run
    t_ip, t_ix, _ = plan.template.np_arrays()
    with torch.no_grad():
        d = plan.numeric(a, b).data
    gdat = (2 * w * d).double().cpu().numpy()
    Gs = sp.csc_matrix((gdat, t_ix, t_ip), shape=(C.m, C.m))
    As = sp.csc_matrix((a_np.astype(np.float64), ixa, ipa), shape=C.shape)
    Bs = sp.csc_matrix((b_np.astype(np.float64), ixb, ipb), shape=CT.shape)
    ra, ca = ixa, np.repeat(np.arange(C.n), np.diff(ipa))
    rb, cb = ixb, np.repeat(np.arange(CT.n), np.diff(ipb))
    ratios = {}
    for name, got, ref, absum, L in (
            ("dA", ga, _on_pattern(Gs @ Bs.T, ra, ca),
             _on_pattern(abs(Gs) @ abs(Bs).T, ra, ca), maps[0][0]),
            ("dB", gb, _on_pattern(As.T @ Gs, rb, cb),
             _on_pattern(abs(As).T @ abs(Gs), rb, cb), maps[1][0])):
        Lmax = int(L.diff().max())
        bound = torch.as_tensor((Lmax + 1) * u * 1.01 * absum, device=dev)
        ratios[name] = _row_ratio(got, torch.as_tensor(ref, device=dev),
                                  bound)
    _grad_log("SpGEMMPlan conn200k f32", times, None,
              " worst_entry_err_over_bound_vs_scipy: " + " ".join(
                  f"{k}={v:.4f}" for k, v in ratios.items())
              + " (bound (L+1) u |G||B^T| per entry; must be <= 1)")
    if not all(v <= 1 for v in ratios.values()):
        raise AssertionError("grad[SpGEMMPlan]: disagrees with scipy")

    def loss64():
        d64 = kspg.spgemm_numeric_plain(plan.gid, plan.pa_s, plan.pb_s,
                                        a.detach().double(),
                                        b.detach().double(), plan.out_nnz)
        return float((w.double() * d64 ** 2).sum())

    _fd_check("SpGEMMPlan conn200k f32", loss64, a, ga,
              _nonzero_entries(ga), "product", GRAD_FD_RTOL_F32)

    (gg,), times = _timed_grad(gram_loss, (a,))
    if _timed_grad.last["spgemm_numeric"] != 2:
        raise AssertionError(f"grad[GramPlan]: backward launches "
                             f"{_timed_grad.last}, not two K6 launches")
    g_ip, g_ix, _ = gplan.template.np_arrays()
    with torch.no_grad():
        dg = gplan.numeric(a).data
    Gg = sp.csc_matrix(((2 * wg * dg).double().cpu().numpy(), g_ix, g_ip),
                       shape=(C.m, C.m))
    Gsym = Gg + Gg.T
    bound = torch.as_tensor((2 * int(gplan.seg_ptr.diff().max()) + 2) * u
                            * 1.01 * _on_pattern(abs(Gsym) @ abs(As), ra, ca),
                            device=dev)
    ratio = _row_ratio(gg, torch.as_tensor(_on_pattern(Gsym @ As, ra, ca),
                                           device=dev), bound)
    _grad_log("GramPlan conn200k f32", times, None,
              f" worst_entry_err_over_bound_vs_scipy_(G+G^T)A={ratio:.4f} "
              f"(must be <= 1)")
    if not ratio <= 1:
        raise AssertionError("grad[GramPlan]: disagrees with scipy")

    def gram64():
        lower = kspg.spgemm_numeric_plain(gplan.gid, gplan.pa_s, gplan.pb_s,
                                          a.detach().double(),
                                          a.detach().double(),
                                          gplan.seg_ptr.numel() - 1)
        full = lower.index_select(0, gplan.sel_full)
        return float((wg.double() * full ** 2).sum())

    _fd_check("GramPlan conn200k f32", gram64, a, gg, _nonzero_entries(gg),
              "product", GRAD_FD_RTOL_F32)

    # the launch that gives dA, alone, against its plain version
    seg_ptr, gid, pa, pb = maps[0]
    g = (2 * w * d).detach()
    bv = b.detach()

    def kernel():
        return kspg.spgemm_numeric_cuda(seg_ptr, pa, pb, g, bv)

    def plain():
        return kspg.spgemm_numeric_plain(gid, pa, pb, g, bv, C.nnz)

    yk, yp = kernel(), plain()
    Lmax = int(seg_ptr.diff().max())
    absum = torch.as_tensor(_on_pattern(abs(Gs) @ abs(Bs).T, ra, ca),
                            device=dev)
    r_plain = _row_ratio(yk, yp, 2 * (Lmax + 1) * u * 1.01 * absum)
    err = float((yk - yp).abs().max())
    ms, plain_ms = _time_pair(kernel, plain, 200, 50)
    nbytes = sum(t.numel() * t.element_size() for t in (
        seg_ptr, pa, pb, g, bv, yk))
    rec = dict(launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=None, products=plan.n_products, outputs=C.nnz,
               **bound_record(nbytes, 2 * plan.n_products))
    log(f"grad[SpGEMMPlan conn200k f32]: backward K6 launch for dA (the "
        f"products sorted by entry of A: {C.nnz} outputs of "
        f"{plan.n_products} products, longest run {Lmax}): "
        f"max_abs_err_vs_plain={err:.3e} worst_entry_err_over_bound_vs_plain"
        f"={r_plain:.4f} (must be <= 1) kernel_device_ms={ms:.6f} "
        f"plain_device_ms={plain_ms:.6f} bound_ms={rec['bound_ms']:.6f} "
        f"({rec['bound_by']}, {nbytes} bytes) share_of_bound="
        f"{rec['bound_ms'] / ms:.4f}; library: none (dA is a sum over the "
        f"products of each entry of A: no one torch call computes it)")
    if not r_plain <= 1:
        raise AssertionError("grad[SpGEMMPlan]: the dA launch disagrees")
    _esc_against_k6(dev, C, CT, plan, a, b, w, Bs, ra, ca, seg_ptr)
    return rec


def _esc_against_k6(dev, C, CT, plan, a, b, w, Bs, ra, ca, seg_ptr):
    """The device ESC product's dA (autograd over its gather and segmented
    sum) against K6's dA from ``SpGEMMPlan.numeric`` on the same operands,
    both of the linear loss sum(w * C) (so that both sum the same
    products w_j b_ij): within 2 (L + 1) u |w| |B|^T per entry, L the
    longest run of products of an entry of A."""
    import scipy.sparse as sp
    import torch

    from csparse3_tpu_torch.ops.spgemm_device import ESCSpGEMM

    u = 2.0 ** -24
    t0 = time.perf_counter()
    esc = ESCSpGEMM(C, CT, device=dev)
    t_build = time.perf_counter() - t0
    with torch.no_grad():
        ip, rows, _, nnz = esc(a, b)
    nnz = int(nnz)
    t_ip, t_ix, _ = plan.template.np_arrays()
    if not (nnz == plan.out_nnz and np.array_equal(ip.cpu().numpy(), t_ip)
            and np.array_equal(rows[:nnz].cpu().numpy(), t_ix)):
        raise AssertionError("grad[ESCSpGEMM]: the output pattern differs "
                             "from SpGEMMPlan's")
    (ga_esc,), t_f, t_b = _backward_s(
        lambda: (w * esc(a, b)[2][:nnz]).sum(), (a,))
    (ga_k6,), k_f, k_b = _backward_s(
        lambda: (w * plan.numeric(a, b).data).sum(), (a,))
    Ws = sp.csc_matrix((np.abs(w.double().cpu().numpy()), t_ix, t_ip),
                       shape=(C.m, C.m))
    Lmax = int(seg_ptr.diff().max())
    bound = torch.as_tensor(2 * (Lmax + 1) * u * 1.01 * _on_pattern(
        Ws @ abs(Bs).T, ra, ca), device=dev)
    ratio = _row_ratio(ga_esc, ga_k6, bound)
    log(f"grad[ESCSpGEMM conn200k f32]: capacity={esc.total} products, "
        f"{nnz} outputs, plan build {t_build:.2f} s; dA by autograd "
        f"backward_s={t_b:.4f} (forward_s={t_f:.4f}) against K6's dA from "
        f"SpGEMMPlan.numeric (backward_s={k_b:.4f}, forward_s={k_f:.4f}): "
        f"worst_entry_err_over_bound={ratio:.4f} (bound 2 (L+1) u |w||B|^T"
        f" per entry, L={Lmax}; must be <= 1)")
    if not ratio <= 1:
        raise AssertionError("grad[ESCSpGEMM]: dA disagrees with K6's")


def _grad_bsr_case(dev, Y0):
    """K5 backward: ``BSR @ X`` with imag(Ybus) of 200k buses in (8, 128)
    blocks and X (n, 1024), float32: dX = A^H G through the kernel on the
    adjoint in A's own blocks (``bsr_adjoint``), against scipy on 16
    columns and the plain version; the block values' gradient (plain
    torch) at 3 stored nonzeros against central differences of the
    float64 plain product.  Also times the kernel on the block transpose
    ((128, 8) blocks).  Returns the backward record."""
    import torch

    import csparse3_tpu_torch as pt
    from csparse3_tpu_torch.kernels import bsr_spmm as kbsr
    from csparse3_tpu_torch.ops.bsr_ops import bsr_transpose
    from csparse3_tpu_torch.ops.matvec import bsr_adjoint

    u = 2.0 ** -24
    K_RHS = 1024
    ip, ix, dt = Y0.np_arrays()
    Bm = pt.CSC(Y0.m, Y0.n, ip, ix,
                np.ascontiguousarray(dt.imag).astype(np.float32), device=dev)
    S = Bm.to_scipy().astype(np.float64).tocsc()
    packed = Bm.to_bsr(block=(8, 128))
    bip, bix, bdata = packed.np_arrays()
    d = torch.tensor(bdata, device=dev, requires_grad=True)
    B = pt.BSR(Bm.m, Bm.n, 8, 128, bip, bix, d, device=dev)
    n = Bm.n
    X = torch.tensor(np.random.RandomState(14).rand(n, K_RHS).astype(
        np.float32), device=dev, requires_grad=True)
    t0 = time.perf_counter()
    adj = bsr_adjoint(B)
    cols = B.column_lists()
    log(f"grad[BSR @ X ybus200k f32]: adjoint in (8, 128) blocks and the "
        f"column lists built in {time.perf_counter() - t0:.1f} s: "
        f"{adj.nnz_blocks} blocks for {B.nnz_blocks} of A")

    def loss():
        return ((B @ X) ** 2).sum()

    (gd, gX), times = _timed_grad(loss, (d, X))
    if _timed_grad.last["bsr_spmm"] != 1:
        raise AssertionError(f"grad[BSR @ X]: backward launches "
                             f"{_timed_grad.last}, not one K5 launch")
    with torch.no_grad():
        G = 2 * (B @ X)
    Gh = G[:, :16].double().cpu().numpy()
    ref = torch.as_tensor(S.T @ Gh, device=dev)
    ratio = _row_ratio(gX[:, :16], ref,
                       _rows_bound(S.T, np.abs(Gh), u, dev))
    _grad_log("BSR @ X ybus200k f32", times, None,
              f" dX[:, :16]_worst_row_err_over_bound_vs_scipy_A^T_G="
              f"{ratio:.4f} (bound (k+2) u |A^T||G| per row; must be <= 1)")
    if not ratio <= 1:
        raise AssertionError("grad[BSR @ X]: dX disagrees with scipy")

    def loss64():
        k = B.nnz_blocks
        Y = kbsr.bsr_spmm_plain(B.m, B.n, B.indptr, B.indices[:k],
                                d.detach().double(), X.detach().double(),
                                cols)
        return float((Y ** 2).sum())

    _fd_check("BSR @ X ybus200k f32", loss64, d.view(-1), gd.reshape(-1),
              _nonzero_entries(d), "product", GRAD_FD_RTOL_F32)
    del gd

    # the backward launch alone: K5 on the adjoint, and on the transpose
    Gd = G.detach()
    k = adj.nnz_blocks
    acols = adj.column_lists()
    args = (adj.m, adj.n, adj.indptr, adj.indices[:k], adj.data[:k], Gd)

    def kernel():
        return kbsr.bsr_spmm_cuda(*args, acols)

    yk = kernel()
    yw = kbsr.bsr_spmm_plain(*args, acols)
    yp = kbsr.bsr_spmm_plain(*args)
    bound = _rows_bound(S.T, np.abs(Gh), u, dev)
    r_plain = max(_row_ratio(yk[:, :16], y[:, :16], 2 * bound)
                  for y in (yw, yp))
    err = float((yk - yp).abs().max())
    del yw, yp
    ms, lists_plain_ms = _time_pair(
        kernel, lambda: kbsr.bsr_spmm_plain(*args, acols), 20, 2)
    plain_ms = queued_ms(lambda: kbsr.bsr_spmm_plain(*args), 2)
    with torch.no_grad():
        T = bsr_transpose(B)
    tk = T.nnz_blocks
    targs = (T.m, T.n, T.indptr, T.indices[:tk], T.data[:tk].detach(), Gd)
    tcols = T.column_lists()
    yt = kbsr.bsr_spmm_cuda(*targs, tcols)
    r_t = _row_ratio(yt[:, :16], yk[:, :16], 2 * bound)
    del yt
    t_ms = min(queued_ms(lambda: kbsr.bsr_spmm_cuda(*targs, tcols), 5)
               for _ in range(2))
    lib = _csr_tensor(S.T, dev, np.float32)
    lib_ms = cuda_ms(lambda: lib @ Gd, 5)
    listed = acols[1].numel()
    size = adj.data.element_size()
    nbytes = listed * adj.R * size + sum(
        t.numel() * t.element_size()
        for t in (*acols, adj.indptr, adj.indices[:k], Gd, yk))
    flops = 2 * listed * adj.R * K_RHS
    rec = dict(launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
               lists_plain_ms=lists_plain_ms, library_ms=lib_ms,
               blocks=k, listed_columns=listed,
               transpose_blocks_ms=t_ms,
               transpose_blocks=f"{tk} blocks of ({T.R}, {T.C}), "
                                f"{tcols[1].numel()} listed columns",
               **bound_record(nbytes, flops))
    log(f"grad[BSR @ X ybus200k f32]: backward K5 launch on the adjoint in "
        f"(8, 128) blocks ({k} blocks, {listed} listed columns): "
        f"max_abs_err_vs_plain={err:.3e} worst_row_err_over_bound_vs_plain="
        f"{r_plain:.4f} (16 columns; must be <= 1) kernel_device_ms="
        f"{ms:.6f} lists_plain_device_ms={lists_plain_ms:.6f} "
        f"dense_plain_device_ms={plain_ms:.6f} bound_ms="
        f"{rec['bound_ms']:.6f} ({rec['bound_by']}, {nbytes} bytes, {flops} "
        f"flops) share_of_bound={rec['bound_ms'] / ms:.4f} "
        f"library_torch_sparse_csr_f32_A^T_G_device_ms={lib_ms:.6f}; the "
        f"block transpose ({rec['transpose_blocks']}): kernel_device_ms="
        f"{t_ms:.6f} worst_row_err_over_bound_vs_adjoint={r_t:.4f}")
    if not (r_plain <= 1 and r_t <= 1):
        raise AssertionError("grad[BSR @ X]: the backward launch disagrees")
    return rec


def _grad_solve_cases(dev):
    """Gradients of the banded and LDL^T solves at 10k buses (B + 3I in RCM
    order, float64, torch ops: no kernel of ours): ``BandedLU`` and
    ``LDLTSolvePlan`` in b, ``BandedRefactor`` in b and the values; b
    against scipy's spsolve(A^T, 2x), the values at 3 entries against
    central differences."""
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch.linalg import BandedLU, BandedRefactor, ldlt

    A, Sa, bnp = _b3i_rcm()
    x = spla.spsolve(Sa, bnp)
    gb_ref = spla.spsolve(Sa.T.tocsc(), 2 * x)
    data = A.np_arrays()[2]
    t0 = time.perf_counter()
    lu = BandedLU(A, device=dev)
    ld = ldlt(A).solve_plan(device=dev)
    rf = BandedRefactor.from_matrix(A, device=dev)
    log(f"grad: 10k BandedLU, ldlt solve plan and BandedRefactor built in "
        f"{time.perf_counter() - t0:.1f} s (s={lu.s}, nb={lu.nblocks})")
    for label, solve in (("BandedLU", lu), ("LDLTSolvePlan", ld)):
        b = torch.tensor(bnp, device=dev, requires_grad=True)
        (gb,), times = _timed_grad(lambda: (solve(b) ** 2).sum(), (b,))
        _grad_log(f"{label} 10k f64", times, _rel_err(gb, gb_ref))
    d = torch.tensor(data, device=dev, requires_grad=True)
    b = torch.tensor(bnp, device=dev, requires_grad=True)

    def refactor_loss():
        return (rf(d)(b) ** 2).sum()

    (gd, gb), times = _timed_grad(refactor_loss, (d, b))
    _grad_log("BandedRefactor 10k f64", times, _rel_err(gb, gb_ref))
    _fd_check("BandedRefactor 10k f64", refactor_loss, d, gd,
              (0, len(data) // 2, len(data) - 1), "solve")
    _grad_recurrence_cases(dev, A, lu)


def _grad_recurrence_cases(dev, A, lu):
    """The device block-Thomas recurrences of config 3's blocks (B + 3I at
    10k buses in RCM order, ``lu``'s block size, float64), differentiated
    by autograd over their out-of-place steps: ``thomas_factor_device``
    and ``thomas_factor_device_sym`` (a weighted sum of the factor stacks,
    in D) and ``spike_tips_device`` (a weighted sum of the four tips of the
    first 8 blocks, in uhat), each against central differences at 3
    entries, with the backward's seconds beside the forward's."""
    import torch

    from csparse3_tpu_torch.linalg.banded import (_tridiag_blocks,
                                                  spike_tips_device,
                                                  thomas_factor_device,
                                                  thomas_factor_device_sym)

    perm = lu.perm_host()
    D, E, F = (torch.tensor(m, device=dev) for m in _tridiag_blocks(
        A.n, *A[perm, perm].np_arrays(), lu.s, np.float64))
    rng = np.random.RandomState(21)
    w = torch.as_tensor(rng.randn(3, *D.shape), device=dev)
    nb, s = D.shape[:2]
    # diagonal entries of the first, a middle and the last block
    ks = [k * s * s + 3 * (s + 1) for k in (0, nb // 2, nb - 1)]
    D.requires_grad_()
    for label, factor in (
            ("thomas_factor_device", lambda: thomas_factor_device(D, E, F)),
            ("thomas_factor_device_sym",
             lambda: thomas_factor_device_sym(D, F))):
        def loss():
            return sum((wi * f).sum() for wi, f in zip(w, factor()))

        (gd,), t_f, t_b = _backward_s(loss, (D,))
        log(f"grad[{label} config3 f64]: nb={nb} s={s} backward_s={t_b:.3f} "
            f"(forward_s={t_f:.3f}, taped)")
        _fd_check(f"{label} config3 f64", loss, D.view(-1), gd.reshape(-1),
                  ks, "solve")
    with torch.no_grad():
        eh, si, uh = thomas_factor_device(D, E, F)
    m = min(8, nb - 1)
    uh = uh[:m].clone().requires_grad_()
    Bp, Cp = E[m], F[m - 1]
    wt = torch.as_tensor(rng.randn(4, s, s), device=dev)

    def tips_loss():
        return sum((wi * t).sum() for wi, t in zip(wt, spike_tips_device(
            si[:m], uh, Bp, Cp, ehat=eh[:m])))

    (gu,), t_f, t_b = _backward_s(tips_loss, (uh,))
    log(f"grad[spike_tips_device config3 f64]: m={m} s={s} backward_s="
        f"{t_b:.3f} (forward_s={t_f:.3f}, taped)")
    # the entries of the largest gradients: at the small ones (1e-4 of the
    # largest) central differences are rounding noise
    top = torch.topk(gu.abs().reshape(-1), 3).indices.tolist()
    _fd_check("spike_tips_device config3 f64", tips_loss, uh.view(-1),
              gu.reshape(-1), top, "solve")


# ---------------------------------------------------------------------------
# 18-19. the rest of the public surface at 1M buses: islands, config 5
# ---------------------------------------------------------------------------

N_SURFACE = 1_000_000   # buses of the islands and StreamedSPIKE phases
OUT_SHARE = 0.3         # branches out: kept where RandomState(0).rand > this
NORM_RTOL = 1e-12       # device norms against scipy's
SPIKE_P = 8             # StreamedSPIKE chunks (BASELINE config 5)
SPIKE_S = 2560          # StreamedSPIKE block size (BASELINE config 5)
SPIKE_RESIDUAL = 1e-4   # float64 host residual of a float32 SPIKE solve
N_SPIKE_CHECK = 20_000  # buses of the SPIKE check against device BandedLU
SPIKE_CHECK_RTOL = 1e-4


def _branch_incidence(grid, keep, dev):
    """C = Cf - Ct (branch x bus) of the kept branches, built as the GridCal
    flow builds it: two ``LilMat`` from bulk triplet chunks."""
    from csparse3_tpu_torch import LilMat

    f, t = grid.f[keep], grid.t[keep]
    k = np.arange(len(f))
    cf = LilMat(len(f), grid.n_bus, device=dev).add_triplets(k, f, 1.0)
    ct = LilMat(len(f), grid.n_bus, device=dev).add_triplets(k, t, 1.0)
    return cf.to_csc() - ct.to_csc()


def _islands_case(label, M):
    """Connected components of M's pattern on the card against scipy's
    (exact labels: both number components by their least node).  Returns
    the number of components."""
    import torch
    from scipy.sparse.csgraph import connected_components

    from csparse3_tpu_torch import component_labels
    from csparse3_tpu_torch.ops.graph import (edge_stream, label_round,
                                              propagate_labels)

    t0 = time.perf_counter()
    src, dst = edge_stream(M)               # uploads the entry streams
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    (raw, rounds), wall = _timed(lambda: propagate_labels(M))
    lab0 = torch.arange(M.n, dtype=torch.int64, device=src.device)
    round_ms = min(queued_ms(lambda: label_round(lab0, src, dst), 5)
                   for _ in range(2))
    del src, dst, lab0, raw
    labels, wall_l = _timed(lambda: component_labels(M))
    isl, wall_i = _timed(M.islands)
    t0 = time.perf_counter()
    ncomp, ref = connected_components(M.to_scipy(), directed=False)
    t_sp = time.perf_counter() - t0
    same = bool(np.array_equal(labels, ref))
    lists_ok = (len(isl) == ncomp and bool(np.array_equal(
        np.concatenate(isl), np.argsort(labels, kind="stable"))))
    log(f"islands[{label}]: shape={M.shape} stored={M.nnz} islands="
        f"{len(isl)} rounds={rounds} propagate_wall_s={wall:.4f} "
        f"device_ms_per_round={round_ms:.4f} (queued; x rounds = "
        f"{round_ms * rounds:.3f} ms) component_labels_wall_s={wall_l:.4f} "
        f"islands_wall_s={wall_i:.4f} stream_upload_s={t_up:.3f} "
        f"scipy_connected_components_s={t_sp:.3f} labels_equal_scipy={same} "
        f"island_lists_ok={lists_ok}")
    if not (same and lists_ok):
        raise AssertionError(f"islands[{label}] disagree with scipy")
    return ncomp


def islands_phase(dev, g):
    """The canonical GridCal flow at N_SURFACE buses: LilMat -> C = Cf - Ct
    -> A = C C^T (branch graph) and C^T C (bus graph) -> islands on the
    card, intact and with OUT_SHARE of the branches out; then norms,
    pack_4_by_4 and the io round trips.  Every check raises."""
    import tempfile

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    from csparse3_tpu_torch import BandedLU, CSC, norm, pack_4_by_4
    from csparse3_tpu_torch.models.grids import ybus
    from csparse3_tpu_torch.utils import io as pio

    t_phase = time.perf_counter()
    out = np.random.RandomState(0).rand(g.n_branch) > OUT_SHARE
    for name, keep in (("intact", np.ones(g.n_branch, dtype=bool)),
                       ("out30", out)):
        t0 = time.perf_counter()
        C = _branch_incidence(g, keep, dev)
        t_c = time.perf_counter() - t0
        t0 = time.perf_counter()
        A = C * C.t()
        t_a = time.perf_counter() - t0
        t0 = time.perf_counter()
        Bg = C.t() * C
        t_b = time.perf_counter() - t0
        log(f"islands[{name}]: branches={int(keep.sum())} buses={g.n_bus} "
            f"host_s: LilMat_to_C={t_c:.2f} C_Ct={t_a:.2f} Ct_C={t_b:.2f}")
        n_br = _islands_case(f"{name} branch graph C C^T", A)
        n_bus = _islands_case(f"{name} bus graph C^T C", Bg)
        if name == "intact" and (n_br, n_bus) != (1, 1):
            raise AssertionError("islands: the intact grid is not one "
                                 "island")
        del Bg

    # norms of the last branch graph on the card against scipy
    S = A.to_scipy()
    worst = 0.0
    for o in (1, np.inf, "fro"):
        got = norm(A, o)
        if got.device.type != "cuda":
            raise AssertionError("norm: not on the card")
        ref = spla.norm(S, o)
        worst = max(worst, abs(float(got) - ref) / ref)
    log(f"norm: 1, inf, fro of {A.shape} ({A.nnz} stored) on the card "
        f"max_rel_err_vs_scipy={worst:.3e} (bound {NORM_RTOL:.0e})")
    if worst > NORM_RTOL:
        raise AssertionError("norm disagrees with scipy")

    # pack_4_by_4 of the split-complex Ybus against scipy bmat, exactly
    Y = ybus(g)[0]
    ip, ix, dt = Y.np_arrays()
    re, im, nim = (CSC(Y.m, Y.n, ip, ix, v, device=dev)
                   for v in (dt.real.copy(), dt.imag.copy(), -dt.imag))
    t0 = time.perf_counter()
    P4 = pack_4_by_4(re, nim, im, re)
    t_p = time.perf_counter() - t0
    ref = sp.bmat([[re.to_scipy(), nim.to_scipy()],
                   [im.to_scipy(), re.to_scipy()]], format="csc")
    ref.sort_indices()
    same = P4.shape == ref.shape and all(
        np.array_equal(a, b) for a, b in zip(P4.np_arrays(), (
            ref.indptr, ref.indices, ref.data)))
    log(f"pack_4_by_4: (re, -im; im, re) of Ybus {Y.shape} -> {P4.shape} "
        f"stored={P4.nnz} host_s={t_p:.2f} equal_to_scipy_bmat={same}")
    if not same:
        raise AssertionError("pack_4_by_4 disagrees with scipy")
    del P4, ref, re, im, nim, Y

    # io: A through an npz file (the port, scipy), config 3's BandedLU
    # through its stacks, solving after the load
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        pio.save_npz(f"{tmp}/a.npz", A, compressed=False)
        A2 = pio.load_npz(f"{tmp}/a.npz", device=dev)
        t_io = time.perf_counter() - t0
        same_a = all(np.array_equal(a, b) for a, b in zip(A2.np_arrays(),
                                                          A.np_arrays()))
        same_sp = (sp.load_npz(f"{tmp}/a.npz") != S).nnz == 0
        lu = BandedLU(refactor_system(N_SOLVE), device=dev)
        b = torch.as_tensor(np.random.RandomState(0).rand(lu.n), device=dev)
        x1 = lu(b)
        pio.save_banded(f"{tmp}/lu.npz", lu)
        x2 = pio.load_banded(f"{tmp}/lu.npz", device=dev)(b)
        same_x = bool(torch.equal(x1, x2))
    log(f"io: npz of A ({A.nnz} stored) save+load_s={t_io:.2f} "
        f"arrays_equal={same_a} scipy_reads_it={same_sp}; BandedLU of "
        f"config 3 (n={lu.n}, s={lu.s}) saved and loaded: solve on the card "
        f"equal to the solve before={same_x}")
    if not (same_a and same_sp and same_x):
        raise AssertionError("io round trip changed the data")
    log(f"islands: phase seconds {time.perf_counter() - t_phase:.1f}")


def _bprime_3i(g, dev):
    """B' + 3I of a grid (the series susceptances), built with
    ``from_triplets``, ``diags`` and ``add``."""
    from csparse3_tpu_torch import add, diags, from_triplets

    n = g.n_bus
    bp = 1.0 / g.x
    rows = np.concatenate([g.f, g.t, g.f, g.t])
    cols = np.concatenate([g.f, g.t, g.t, g.f])
    vals = np.concatenate([bp, bp, -bp, -bp])
    return add(from_triplets(rows, cols, vals, (n, n), device=dev),
               diags(np.full(n, 3.0), device=dev))


def spike_flops(sk, first):
    """Operations one solve of ``sk`` (symmetric form) asks for: per chunk
    two factorizations of m blocks (per block an s x s inverse, 2 s^3, and
    two s x s products, 4 s^3; the first block one product), the tips on
    the first solve (8 s^3 a block), the reduced factor on the first solve
    (per interface an inverse and eight products), and the sweeps."""
    s3, m, P = float(sk.s) ** 3, sk.m, sk.P
    factor = (6 * m - 2) * s3
    tips = (8 * (m - 1) + 4) * s3 if first else 0.0
    reduced = 18 * (P - 1) * s3 if first else 0.0
    sweeps = 2 * 3 * 2 * P * m * float(sk.s) ** 2
    return P * (2 * factor + tips) + reduced + sweeps


def spike_phase(dev, g):
    """BASELINE config 5 on one card: B' + 3I of the N_SURFACE-bus grid in
    RCM order, StreamedSPIKE(P=8, s=2560) in float32, two solves against
    the float64 host residual; then a 20k-bus system against the device
    BandedLU.  Every check raises."""
    import torch

    from csparse3_tpu_torch import StreamedSPIKE
    from csparse3_tpu_torch.linalg import BandedLU, rcm
    from csparse3_tpu_torch.models.grids import synthetic_grid

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    A0 = _bprime_3i(g, dev)
    perm = rcm(A0)
    A = A0[perm, perm]
    t_build = time.perf_counter() - t0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    sk = StreamedSPIKE(A, P=SPIKE_P, ordering=None, s=SPIKE_S, device=dev)
    torch.cuda.synchronize()
    t_sym = time.perf_counter() - t0
    log(f"spike: B'+3I n={A.n} stored={A.nnz} build+rcm_s={t_build:.1f} "
        f"symbolic_s={t_sym:.2f} P={sk.P} m={sk.m} s={sk.s} bw={sk.bw} "
        f"symmetric={sk._sym} float32")
    S = A.to_scipy().tocsr()
    torch.cuda.reset_peak_memory_stats(dev)
    xs_sk = {}
    for i, (seed, first) in enumerate(((3, True), (4, False))):
        b = np.random.RandomState(seed).rand(A.n).astype(np.float32)
        x, secs = _timed(lambda: sk(b))
        xs_sk[seed] = x
        res = float(np.linalg.norm(S @ x.astype(np.float64) - b)
                    / np.linalg.norm(b))
        flops = spike_flops(sk, first)
        bound_s = flops / F32_FLOP_PER_S
        what = "first: tips, reduced factor" if first else "warm: tips kept"
        log(f"spike: solve {i + 1} ({what}) wall_s={secs:.3f} "
            f"flops={flops:.4e} flop_bound_s={bound_s:.3f} (float32 at {F32_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
            f"{bound_s / secs:.3f} of it) rel_residual_f64={res:.3e} "
            f"(bound {SPIKE_RESIDUAL:.0e})")
        if not res < SPIKE_RESIDUAL:
            raise AssertionError("spike: residual above its bound")
    peak = torch.cuda.max_memory_allocated(dev)
    chunk = sk.m * sk.s * sk.s * 4
    log(f"spike: peak_device_GB={peak / 1e9:.2f} (above the "
        f"{base / 1e9:.2f} GB held before; one chunk's (m, s, s) float32 "
        f"stack {chunk / 1e9:.3f} GB, all P chunks' "
        f"{SPIKE_P * chunk / 1e9:.1f} GB)")
    del sk
    spike_distributed(dev, A, S, xs_sk[3])
    del A, A0, S

    # the 20k-bus system against the device BandedLU (float64)
    gc = synthetic_grid(N_SPIKE_CHECK, seed=0)
    Ac = _bprime_3i(gc, dev)
    pc = rcm(Ac)
    Ac = Ac[pc, pc]
    b = np.random.RandomState(3).rand(Ac.n)
    x = StreamedSPIKE(Ac, P=4, ordering=None, device=dev)(b)
    lu, _ = BandedLU.factor_device(Ac, ordering=None, dtype=torch.float64,
                                   device=dev)
    ref = lu(b).cpu().numpy()
    err = float(np.abs(x - ref).max() / np.abs(ref).max())
    log(f"spike: {N_SPIKE_CHECK}-bus B'+3I (RCM) StreamedSPIKE(P=4) float32 "
        f"against the device BandedLU float64: max_err_over_max={err:.3e} "
        f"(bound {SPIKE_CHECK_RTOL:.0e})")
    if not err <= SPIKE_CHECK_RTOL:
        raise AssertionError("spike disagrees with the device BandedLU")
    log(f"spike: phase seconds {time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# the distributed layer (Mesh.virtual on the card)
# ---------------------------------------------------------------------------

MESH_S = 8               # positions of the virtual mesh (the dry run's 8)
N_PAR = 100_000          # buses of the ring, Krylov and host SPIKE stages
N_PAR_COMPLEX = 25_000   # buses of the complex device SPIKE stage
N_SCHUR = 50_000         # buses of the Schur stage
PAR_RESIDUAL = 1e-4      # float64 host residual of every distributed solve
PAR_SPMV_RTOL = 1e-12    # dist_spmv (float64) against scipy, of max|y|
PAR_CG_TOL = 1e-6        # the dry run's CG tolerance
SHARDED_RTOL = 1e-12     # run_sharded against run, of the largest value
N_SHARDED = 300          # DC and linear outages of run_sharded
N_SHARDED_AC = 32        # AC outages of run_sharded


def _host_residual(S, x, b):
    x = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return float(np.linalg.norm(S @ x.astype(np.result_type(x, np.float64))
                                - b) / np.linalg.norm(b))


def _spmv_check(label, part, A, x, mesh):
    """dist_spmv of ``part`` against scipy on the host; returns the padded
    product."""
    from csparse3_tpu_torch.parallel import dist_spmv

    y, secs = _timed(lambda: dist_spmv(part, x, mesh))
    ref = A.to_scipy() @ x
    err = _rel_err(y[: A.n], ref)
    log(f"parallel[{label}]: {part!r} entries_per_group={part.e_vals.shape[-1]}"
        f" first_call_s={secs:.3f} max_err_over_max_vs_scipy={err:.3e} "
        f"(bound {PAR_SPMV_RTOL:.0e})")
    if not err <= PAR_SPMV_RTOL:
        raise AssertionError(f"parallel[{label}]: dist_spmv disagrees with "
                             "scipy")
    return y


def _backward_s(loss_fn, inputs):
    """(gradients, forward s, backward s) of one forward and one backward,
    each timed by the host clock to a synchronize, outside inference
    mode."""
    import torch

    with torch.inference_mode(False):
        loss, t_f = _timed(loss_fn)
        grads, t_b = _timed(lambda: torch.autograd.grad(loss, inputs))
    return grads, t_f, t_b


def _dist_spmv_grad(label, part, A, x, mesh):
    """The backward of ``dist_spmv`` in x and in the partition's values
    (``with_values``): dx against scipy's A^T g within the product gate,
    the values' gradient at 3 stored entries against g[row] x[col]."""
    import torch

    from csparse3_tpu_torch.parallel import dist_spmv

    dev = mesh.devices[0]
    rng = np.random.RandomState(7)
    with torch.inference_mode(False):
        g = torch.as_tensor(rng.rand(part.m_pad), device=dev)
        xt = torch.tensor(part.pad_vector(x), device=dev, requires_grad=True)
        ev = torch.tensor(part.e_vals, device=dev, requires_grad=True)
        pv = part.with_values(ev)
    (gx, gv), t_f, t_b = _backward_s(
        lambda: (dist_spmv(pv, xt, mesh) * g).sum(), (xt, ev))
    gnp = g.cpu().numpy()
    err = _rel_err(gx[: A.n], A.to_scipy().T @ gnp[: A.n])
    # three stored entries: position, group, slot -> global row and column
    live = np.argwhere(part.e_rows < part.mloc)
    xp = part.pad_vector(x)
    worst = 0.0
    for i in np.linspace(0, len(live) - 1, 3).astype(int):
        idx = tuple(live[i])
        s_ = idx[0]
        row = s_ * part.mloc + int(part.e_rows[idx])
        col = int(part.e_cols[idx])
        if part.strategy == "ring":
            col += (s_ + idx[1] - part.k) * part.mloc
        want = gnp[row] * xp[col]
        worst = max(worst, abs(float(gv[idx]) - want) / max(abs(want),
                                                             1e-300))
    log(f"parallel[{label} grad]: dist_spmv backward_s={t_b:.4f} "
        f"(forward_s={t_f:.4f}) dx max_err_over_max_vs_scipy_A^T_g="
        f"{err:.3e} (bound {PAR_SPMV_RTOL:.0e}) values' gradient at 3 "
        f"stored entries against g[row] x[col]: worst relative gap "
        f"{worst:.3e} (bound {PAR_SPMV_RTOL:.0e})")
    if not (err <= PAR_SPMV_RTOL and worst <= PAR_SPMV_RTOL):
        raise AssertionError(f"parallel[{label} grad]: the backward of "
                             "dist_spmv disagrees")


def parallel_phase(dev):
    """The distributed layer on Mesh.virtual(MESH_S, dev), at the JAX
    package's dry-run sizes (see the module docstring).  Every check
    raises."""
    import torch

    from csparse3_tpu_torch import add, diags, from_triplets, spmv
    from csparse3_tpu_torch.linalg import rcm
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus
    from csparse3_tpu_torch.parallel import (BlockJacobi, DiagJacobi,
                                             DistBandedLU, Mesh, SchurLU,
                                             dist_cg, dist_spmv,
                                             partition_rows, spmv_local)

    t_phase = time.perf_counter()
    mesh = Mesh.virtual(MESH_S, dev)
    N = N_PAR
    t0 = time.perf_counter()
    A0 = _bprime_3i(synthetic_grid(N, seed=1), dev)
    perm = rcm(A0)
    A = A0[perm, perm]
    S = A.to_scipy().tocsr()
    x = np.linspace(0.0, 1.0, N)
    log(f"parallel: {mesh!r}; B'+3I n={N} stored={A.nnz} (RCM) build_s="
        f"{time.perf_counter() - t0:.1f}")

    # ---- the ring, its product against one device's
    t0 = time.perf_counter()
    part = partition_rows(A, MESH_S)
    t_part = time.perf_counter() - t0
    if not (part.strategy == "ring" and part.k >= 1):
        raise AssertionError(f"parallel: expected a k >= 1 ring, got {part}")
    log(f"parallel: partition_rows host_s={t_part:.2f}")
    _spmv_check("ring", part, A, x, mesh)
    _dist_spmv_grad("ring", part, A, x, mesh)
    xt = torch.as_tensor(part.pad_vector(x), device=dev)
    xs = mesh.scatter(xt, part.mloc)
    dist_ms = cuda_ms(lambda: dist_spmv(part, xt, mesh), 20)
    local_ms = cuda_ms(lambda: spmv_local(part, xs, mesh), 20)
    x1 = xt[:N]
    one_ms = cuda_ms(lambda: spmv(A, x1), 20)
    log(f"parallel[ring]: dist_spmv_ms={dist_ms:.4f} (padded x in, product "
        f"on one device out) spmv_local_ms={local_ms:.4f} (per-position "
        f"slices; {MESH_S} positions x {2 * part.k + 1} groups) "
        f"one_device_spmv_ms={one_ms:.4f} (entry streams, the same matrix) "
        f"ratio_local_over_one={local_ms / one_ms:.2f}")

    # ---- k >= 2: long lines at ~1.5x the block width
    mloc = part.mloc
    far = np.arange(0, N - 3 * mloc // 2 - 1, N // 64)
    A2 = add(A, from_triplets(
        np.concatenate([far, far + 3 * mloc // 2]),
        np.concatenate([far + 3 * mloc // 2, far]),
        np.full(2 * len(far), 0.01), (N, N), device=dev))
    part2 = partition_rows(A2, MESH_S)
    if not (part2.strategy == "ring" and part2.k >= 2):
        raise AssertionError(f"parallel: expected a k >= 2 ring, got {part2}")
    _spmv_check("ring_k2", part2, A2, x, mesh)
    _dist_spmv_grad("ring_k2", part2, A2, x, mesh)
    del A2, part2

    # ---- a random permutation: the all-gather strategy
    rp = np.random.RandomState(0).permutation(N)
    Ar = A[rp, rp]
    part_ag = partition_rows(Ar, MESH_S)
    if part_ag.strategy != "allgather":
        raise AssertionError(f"parallel: expected allgather, got {part_ag}")
    _spmv_check("allgather", part_ag, Ar, x, mesh)
    _dist_spmv_grad("allgather", part_ag, Ar, x, mesh)
    del Ar, part_ag

    # ---- distributed CG: BlockJacobi (the dry run's), DiagJacobi, none
    b = np.random.RandomState(0).rand(N)
    t0 = time.perf_counter()
    bj = BlockJacobi.build(A, part)
    t_bj = time.perf_counter() - t0
    # the block plans on the card: 'auto' (dense tails, BlockJacobi's)
    # against 'level' (the JAX package's layout), built and applied alone
    ones = [torch.ones(part.mloc, dtype=torch.float64, device=dev)] * MESH_S
    for style in ("auto", "level"):
        plans, t_pl = _timed(lambda: [lu.solve_plan(style, device=dev)
                                      for lu in bj.lus])
        ms = cuda_ms(lambda: [p(r) for p, r in zip(plans, ones)], 5)
        log(f"parallel[block_jacobi plans {style}]: device_build_s="
            f"{t_pl:.2f} apply_ms={ms:.3f} ({MESH_S} blocks of "
            f"{part.mloc}, one right-hand side each)")
    del plans, ones
    for name, prec, maxiter in (("block_jacobi", bj, 200),
                                ("diag_jacobi", DiagJacobi.build(A, part),
                                 5000),
                                ("none", None, 5000)):
        (xs_, res, it), secs = _timed(lambda: dist_cg(
            part, b, mesh, prec=prec, tol=PAR_CG_TOL, maxiter=maxiter))
        rel = _host_residual(S, xs_, b)
        extra = f" build_s={t_bj:.2f}" if prec is bj else ""
        log(f"parallel[dist_cg {name}]: iterations={it} wall_s={secs:.3f} "
            f"ms_per_iteration={1e3 * secs / max(it, 1):.3f} "
            f"rel_residual_f64={rel:.3e} (bound {PAR_RESIDUAL:.0e}){extra}")
        if not (rel < PAR_RESIDUAL and it < maxiter):
            raise AssertionError(f"parallel: dist_cg {name} did not "
                                 "converge")
    del bj

    # ---- the host-factored SPIKE at 100k
    t0 = time.perf_counter()
    dk = DistBandedLU(A, mesh=mesh, ordering=None)
    t_fac = time.perf_counter() - t0
    for what in ("first (uploads the stacks)", "warm"):
        xk, secs = _timed(lambda: dk(b))
        rel = _host_residual(S, xk, b)
        log(f"parallel[DistBandedLU host]: P={dk.P} s={dk.s} m={dk.m} "
            f"float64 host_factor_s={t_fac:.2f} solve {what} wall_s="
            f"{secs:.3f} rel_residual_f64={rel:.3e} (bound "
            f"{PAR_RESIDUAL:.0e})")
        if not rel < PAR_RESIDUAL:
            raise AssertionError("parallel: host DistBandedLU residual")
    del dk, part, A, A0, S

    # ---- the device SPIKE factor of a complex system
    Nc = N_PAR_COMPLEX
    Yc = ybus(synthetic_grid(Nc, seed=2))[0]
    Ac = add(Yc.to(dev), diags(np.full(Nc, 3.0 + 0.5j), device=dev))
    dkd, t_dfac = _timed(lambda: DistBandedLU.factor_device(Ac, mesh=mesh))
    bc = (np.random.RandomState(4).rand(Nc)
          + 1j * np.random.RandomState(5).rand(Nc))
    xkd, secs = _timed(lambda: dkd(bc))
    rel = _host_residual(Ac.to_scipy().tocsr(), xkd, bc)
    log(f"parallel[DistBandedLU.factor_device complex]: n={Nc} (real "
        f"embedding {2 * Nc}, s={dkd.s}, m={dkd.m}, P={dkd.P}) float32 "
        f"factor_s={t_dfac:.2f} solve_s={secs:.3f} rel_residual_f64="
        f"{rel:.3e} (bound {PAR_RESIDUAL:.0e})")
    if not rel < PAR_RESIDUAL:
        raise AssertionError("parallel: complex device SPIKE residual")
    _complex_spike_grad(dkd, Ac, bc, secs)
    del dkd, Ac, Yc

    # ---- Schur-complement domain decomposition at 50k
    Ns = N_SCHUR
    As0 = _bprime_3i(synthetic_grid(Ns, seed=1), dev)
    ps = rcm(As0)
    As = As0[ps, ps]
    t0 = time.perf_counter()
    schur = SchurLU(As, S=MESH_S)
    plan = schur.device_plan(device=dev)
    t_schur = time.perf_counter() - t0
    bs = np.ones(Ns)
    for what in ("first (places the shards)", "warm"):
        xd, secs = _timed(lambda: plan.dist_solve(bs, mesh, axis="rows"))
        rel = _host_residual(As.to_scipy().tocsr(), xd, bs)
        log(f"parallel[SchurLU]: n={Ns} S={MESH_S} interface="
            f"{schur.n_interface} build_s={t_schur:.2f} dist_solve {what} "
            f"wall_s={secs:.3f} rel_residual_f64={rel:.3e} (bound "
            f"{PAR_RESIDUAL:.0e})")
        if not rel < PAR_RESIDUAL:
            raise AssertionError("parallel: Schur residual")
    # the backward: A^T db = g through the transposed Schur solve
    St = As.to_scipy().T.tocsr()
    with torch.inference_mode(False):
        gs = torch.as_tensor(np.random.RandomState(6).rand(Ns), device=dev)
        bt = torch.tensor(bs, device=dev, requires_grad=True)
    for what in ("first (builds the adjoint plans)", "warm"):
        (db,), t_f, t_b = _backward_s(lambda: (plan.dist_solve(
            bt, mesh, axis="rows") * gs).sum(), (bt,))
        rel = _host_residual(St, db, gs.cpu().numpy())
        log(f"parallel[SchurLU grad]: dist_solve backward {what} wall_s="
            f"{t_b:.3f} (forward_s={t_f:.3f}) ||A^T db - g|| / ||g|| = "
            f"{rel:.3e} (bound {PAR_RESIDUAL:.0e})")
        if not rel < PAR_RESIDUAL:
            raise AssertionError("parallel: Schur backward residual")
    log(f"parallel: phase seconds {time.perf_counter() - t_phase:.1f}")


def _complex_spike_grad(dk, A, b, solve_s):
    """The backward of ``solve_blocks`` of the real embedding that
    ``DistBandedLU.factor_device`` factored for the complex ``A``: with L =
    Re(g^H x), the embedded gradient mapped back is db = A^{-H} g; checked
    as ||A^H db - g|| / ||g|| on the host."""
    import torch

    from csparse3_tpu_torch.ops.construct import (complex_rhs_to_real,
                                                  real_x_to_complex)

    rng = np.random.RandomState(8)
    g = rng.rand(A.n) + 1j * rng.rand(A.n)
    b2, squeeze = complex_rhs_to_real(b, dk._cplx_perm)
    with torch.inference_mode(False):
        # copies made outside inference mode: the product saves them
        g2 = [t.clone() for t in dk.blocks(
            complex_rhs_to_real(g, dk._cplx_perm)[0])]
        bbs = [t.clone().requires_grad_() for t in dk.blocks(b2)]
    grads, t_f, t_b = _backward_s(lambda: sum(
        (x * w).sum() for x, w in zip(dk.solve_blocks(bbs), g2)), bbs)
    db = real_x_to_complex(dk.unblocks([t.detach() for t in grads]),
                           dk._cplx_perm, squeeze)
    rel = _host_residual(A.to_scipy().conj().T.tocsr(), db, g)
    log(f"parallel[DistBandedLU.factor_device complex grad]: solve_blocks "
        f"backward_s={t_b:.3f} (forward_s={t_f:.3f}; the whole solve "
        f"{solve_s:.3f} s) ||A^H db - g|| / ||g|| = {rel:.3e} (bound "
        f"{PAR_RESIDUAL:.0e})")
    if not rel < PAR_RESIDUAL:
        raise AssertionError("parallel: complex device SPIKE backward")


def _sharded_check(name, study, mesh, ks, rtol=SHARDED_RTOL):
    """``study.run_sharded`` against ``study.run`` on the same outages: the
    masks and counts equal, the values of the outages ``run`` marks sound
    (its last output) within ``rtol`` of the largest; raises."""
    import torch

    got, t_sh = _timed(lambda: study.run_sharded(mesh, ks))
    want, t_run = _timed(lambda: study.run(ks))
    ok = want[-1]
    worst, bits = 0.0, True
    for g, w in zip(got, want):
        if g.shape != w.shape or g.device != w.device:
            raise AssertionError(f"studies[{name} run_sharded]: shape or "
                                 "device differs from run")
        if w.dtype in (torch.bool, torch.int64):
            if not torch.equal(g, w):
                raise AssertionError(f"studies[{name} run_sharded]: a mask "
                                     "or count differs from run")
            continue
        g, w = g[ok], w[ok]
        bits &= bool(torch.equal(g, w))
        worst = max(worst, float((g - w).abs().max())
                    / max(float(w.abs().max()), 1e-300))
    log(f"studies[{name} run_sharded]: outages={len(ks)} (sound "
        f"{int(ok.sum())}) over {mesh!r} wall_s={t_sh:.3f} (run alone "
        f"{t_run:.3f}) max_rel_diff_vs_run={worst:.3e} (bound {rtol:.0e}) "
        f"bitwise_equal={bits}")
    if worst > rtol:
        raise AssertionError(f"studies[{name} run_sharded] disagrees with "
                             "run")


def spike_distributed(dev, A, S, x_sk):
    """Config 5 distributed: the RCM B' + 3I ``A`` (scipy ``S``) over
    Mesh.virtual(SPIKE_P, dev): ``partition_rows`` + ``dist_spmv`` against
    scipy, then ``DistBandedLU.factor_device`` in float32 (s = SPIKE_S), a
    first and a warm solve of the RandomState(3) right-hand side against
    the host residual and against StreamedSPIKE's solution ``x_sk``.
    Every check raises."""
    import torch

    from csparse3_tpu_torch.parallel import (DistBandedLU, Mesh, dist_spmv,
                                             partition_rows)

    mesh = Mesh.virtual(SPIKE_P, dev)
    t0 = time.perf_counter()
    part = partition_rows(A, SPIKE_P)
    t_part = time.perf_counter() - t0
    log(f"spike[distributed]: {mesh!r} partition_rows host_s={t_part:.2f}")
    x = np.linspace(0.0, 1.0, A.n)
    _spmv_check("config5 ring", part, A, x, mesh)
    xt = torch.as_tensor(part.pad_vector(x), device=dev)
    ms = cuda_ms(lambda: dist_spmv(part, xt, mesh), 10)
    log(f"spike[distributed]: dist_spmv_ms={ms:.3f} (n={A.n}, float64)")
    del part, xt

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dk, t_fac = _timed(lambda: DistBandedLU.factor_device(
        A, mesh=mesh, ordering=None, s=SPIKE_S))
    held = torch.cuda.memory_allocated(dev) - base
    b = np.random.RandomState(3).rand(A.n).astype(np.float32)
    # the kept factors, read once: the least bytes a solve must move
    stacks = (2 if dk._sym else 3) * dk.P * dk.m * dk.s ** 2 * 4
    bound_ms = 1e3 * stacks / HBM_BYTES_PER_S
    for what in ("first", "warm"):
        x, secs = _timed(lambda: dk(b))
        res = float(np.linalg.norm(S @ x.astype(np.float64) - b)
                    / np.linalg.norm(b))
        err = float(np.abs(x - x_sk).max() / np.abs(x_sk).max())
        log(f"spike[distributed]: DistBandedLU.factor_device P={dk.P} "
            f"s={dk.s} m={dk.m} symmetric={dk._sym} float32 factor_s="
            f"{t_fac:.3f} solve {what} wall_s={secs:.4f} (byte bound of the "
            f"kept factors read once {bound_ms:.2f} ms) rel_residual_f64="
            f"{res:.3e} (bound {SPIKE_RESIDUAL:.0e}) max_err_over_max_vs_"
            f"StreamedSPIKE={err:.3e} (bound {SPIKE_CHECK_RTOL:.0e})")
        if not (res < SPIKE_RESIDUAL and err <= SPIKE_CHECK_RTOL):
            raise AssertionError("spike[distributed]: residual or agreement "
                                 "with StreamedSPIKE out of bounds")
    peak = torch.cuda.max_memory_allocated(dev) - base
    log(f"spike[distributed]: peak_device_GB={peak / 1e9:.2f} held_after_"
        f"factor_GB={held / 1e9:.2f} (above the {base / 1e9:.2f} GB held "
        f"before; kept factor stacks {stacks / 1e9:.2f} GB)")

    # the backward of solve_blocks: the adjoint SPIKE solve, A^T db = g
    g = np.random.RandomState(5).rand(A.n).astype(np.float32)
    with torch.inference_mode(False):
        gb = [t.clone() for t in dk.blocks(g)]
        bbs = [t.clone().requires_grad_() for t in dk.blocks(b)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    grads, t_f, t_b = _backward_s(lambda: sum(
        (x * w).sum() for x, w in zip(dk.solve_blocks(bbs), gb)), bbs)
    peak_b = torch.cuda.max_memory_allocated(dev) - base
    db = dk.unblocks([t.detach() for t in grads])[:, 0]
    res = float(np.linalg.norm(S.T @ db.astype(np.float64) - g)
                / np.linalg.norm(g))
    log(f"spike[distributed]: solve_blocks backward wall_s={t_b:.4f} "
        f"(its forward {t_f:.4f} s, the warm solve {secs:.4f} s) "
        f"||A^T db - g|| / ||g|| = {res:.3e} (bound {SPIKE_RESIDUAL:.0e}) "
        f"peak_device_GB={peak_b / 1e9:.2f} (above the same {base / 1e9:.2f}"
        f" GB; the factor's peak {peak / 1e9:.2f} GB)")
    if not res < SPIKE_RESIDUAL:
        raise AssertionError("spike[distributed]: the backward's residual "
                             "is out of bounds")
    del dk, grads, bbs, gb


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
        estimation_phase(dev)
        krylov_launches, krylov = krylov_phase(dev)
        ldlt_phase(dev)
        with torch.inference_mode(False):
            grad = grad_phase(dev)
        # the rest of the public surface at 1M buses (no kernel of ours)
        t0 = time.perf_counter()
        g1m = synthetic_grid(N_SURFACE, seed=0)
        log(f"surface: synthetic_grid({N_SURFACE}, seed=0) branches="
            f"{g1m.n_branch} seconds {time.perf_counter() - t0:.1f}")
        islands_phase(dev, g1m)
        spike_phase(dev, g1m)
        del g1m
        parallel_phase(dev)
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
        # three solves, of the blocklu phase's three and of the krylov
        # phase's four solvers (cg, bicgstab, gmres and refine, one launch
        # per matvec; their shape, times and counts under "krylov").  bound_ms
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
                    dia_launches + blocklu_launches + krylov_launches,
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
             krylov=krylov,
             # the backward products of the grad phase: its launches are
             # those of the timed backward passes (DIAPlan, SplitDIA and
             # SplitSymDIA at 10k in float64, SplitDIA at 200k in float32),
             # each one launch on the transposed plan; the top-level numbers
             # are SplitDIA's launch over its adjoint pair (A_r^T, -A_i^T)
             # at the 10k float64 shape, library_ms the complex128 CSR
             # product A^H g
             backward=grad["dia_spmv"],
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
             conn3000=spg["conn3000"], rand10k=spg["rand10k"],
             # the backward: the launch that gives dA of SpGEMMPlan on
             # conn200k (float32), the kernel over the products sorted by
             # entry of A; its launches are those of the grad phase's timed
             # backward passes (two per SpGEMMPlan or GramPlan gradient);
             # no one library call computes dA
             backward=grad["spgemm_numeric"]),
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
             block_matrix_32x32=bsr["block32"],
             # the backward: dX = A^H G of BSR @ X on ybus200k (float32,
             # X (n, 1024)), one launch on the adjoint in (8, 128) blocks;
             # transpose_blocks_ms the same product on the block transpose's
             # (128, 8) blocks; library_ms torch.sparse CSR A^T @ G
             backward=grad["bsr_spmm"]),
    ]}))
    log(f"total seconds {time.perf_counter() - t_all:.1f}")
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
