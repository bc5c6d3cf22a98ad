#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root, one GPU

Phases (any failure raises, and the script exits non-zero):

1. device: needs torch.cuda; prints the card's name and power limit.
2. build:  compiles both libraries from this checkout into
           csparse3_tpu_torch/_build/ (nvcc: csrc/bandpoints.cu for sm_90a;
           g++: native/host_ext.cpp + native/lu_sn.cpp) and prints the
           seconds each took.
3. kernel: the band+points SpMV on the 200k-bus synthetic Ybus (the JAX
           bench's ``spmv_bp`` matrix): the CUDA kernel against its plain
           PyTorch version on the card and against scipy complex128 on the
           host, for the default plan and for an offset-group plan (the
           points-only launches); CUDA-event times of both versions.
4. newton: NewtonPowerFlow(synthetic_grid(10_000, seed=3), spmv='bandpoints',
           solver='level', tol=5e-5) on the card from flat start: it must
           converge, its state must give a host float64 scipy mismatch
           <= 1e-4, the kernel must have launched once per mismatch
           evaluation, and the state must agree with the port's own
           float64 spmv='ell' solve.  Then the same on ieee14().

Prints one JSON line of kernel records, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np

# kernel vs plain / scipy: float32 sums of a handful of complex products
# per row, in different orders; 5e-6 of max|y| is ~40 float32 ulps
SPMV_REL = 5e-6
# bandpoints (float32 SpMV, stops at mismatch <= 5e-5) vs ell (float64)
STATE_ATOL = 1e-4
HOST_MISMATCH = 1e-4


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


def kernel_phase(dev):
    import torch

    from csparse3_tpu_torch import SplitBandPoints
    from csparse3_tpu_torch.models.grids import synthetic_grid, ybus

    t0 = time.perf_counter()
    Y, _, _ = ybus(synthetic_grid(200_000, seed=0))
    n = Y.n
    rng = np.random.RandomState(0)
    xr, xi = rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32)
    z = Y.to_scipy() @ (xr.astype(np.float64) + 1j * xi)
    z2 = np.stack([z.real, z.imag])
    xr_t, xi_t = torch.as_tensor(xr, device=dev), torch.as_tensor(xi, device=dev)
    out = {}
    for label, kw in (("default", {}), ("groups", dict(group_span=512))):
        plan = SplitBandPoints(Y, device=dev, **kw)
        yk = torch.stack(plan(xr_t, xi_t))
        torch.cuda.synchronize()
        if plan.kernel_launches != plan.n_groups:
            raise AssertionError(f"{label}: {plan.kernel_launches} launches "
                                 f"for {plan.n_groups} groups")
        if label == "groups" and plan.n_groups < 2:
            raise AssertionError("groups: no points-only launch")
        yp = torch.stack(plan.plain(xr_t, xi_t))
        scale = float(yp.abs().max())
        abs_plain = float((yk - yp).abs().max())
        abs_scipy = float(np.abs(yk.cpu().numpy() - z2).max())
        log(f"kernel[{label}]: n={n} nnz={Y.nnz} heavy_diagonals="
            f"{plan.core_ndiag} groups={plan.n_groups} "
            f"rel_err_vs_plain={abs_plain / scale:.3e} "
            f"rel_err_vs_scipy_c128={abs_scipy / scale:.3e} "
            f"bound={SPMV_REL:.0e}")
        if abs_plain > SPMV_REL * scale or abs_scipy > SPMV_REL * scale:
            raise AssertionError(f"{label}: kernel disagrees")
        for _ in range(20):
            plan(xr_t, xi_t)
            plan.plain(xr_t, xi_t)
        # plain, kernel, kernel, plain: one card, one call
        t = [cuda_ms(lambda: plan.plain(xr_t, xi_t), 200),
             cuda_ms(lambda: plan(xr_t, xi_t), 200),
             cuda_ms(lambda: plan(xr_t, xi_t), 200),
             cuda_ms(lambda: plan.plain(xr_t, xi_t), 200)]
        log(f"kernel[{label}]: wrapper_ms_per_call={min(t[1], t[2]):.6f} "
            f"plain_ms_per_call={min(t[0], t[3]):.6f} (cuda events over "
            f"200 back-to-back calls, best of 2, host overhead included; "
            f"runs plain,kernel,kernel,plain = {t})")
        # device time alone, from the profiler's kernel records
        _, kbusy, klaunch, kby = device_profile(lambda: plan(xr_t, xi_t), 50)
        kname = [k for k in kby if "band_points_kernel" in k]
        kcount, ksec = kby[kname[0]]
        _, pbusy, plaunch, _ = device_profile(
            lambda: plan.plain(xr_t, xi_t), 50)
        ms, plain_ms = ksec / 50 * 1e3, pbusy / 50 * 1e3
        log(f"kernel[{label}]: kernel_device_ms_per_call={ms:.6f} "
            f"({kcount / 50:.0f} launches) plain_device_ms_per_call="
            f"{plain_ms:.6f} ({plaunch / 50:.0f} kernels) wrapper_device_"
            f"ms_per_call={kbusy / 50 * 1e3:.6f} ({klaunch / 50:.0f} "
            f"kernels) (torch.profiler, 50 calls)")
        out[label] = dict(abs_err=abs_plain, ms=ms, plain_ms=plain_ms)
    log(f"kernel: phase seconds {time.perf_counter() - t0:.1f}")
    return out["default"]


def newton_case(name, grid, dev, solves=1, profile_solve=False):
    import torch

    from csparse3_tpu_torch.models.powerflow import NewtonPowerFlow

    t0 = time.perf_counter()
    pf = NewtonPowerFlow(grid, spmv="bandpoints", solver="level", tol=5e-5,
                         device=dev)
    t_build = time.perf_counter() - t0
    plan = pf._yplan
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
    # one launch per point group per mismatch evaluation: it + 1 of them
    if launches == 0 or launches != (it + 1) * plan.n_groups:
        raise AssertionError(f"{name}: {launches} launches for {it + 1} "
                             f"mismatch evaluations")
    t0 = time.perf_counter()
    vm_e, va_e, it_e, res_e = NewtonPowerFlow(
        grid, spmv="ell", solver="level", device=dev).solve()
    diff = max(np.abs(vm - vm_e).max(), np.abs(va - va_e).max())
    log(f"newton[{name}]: ell_f64 iterations={it_e} residual={res_e:.3e} "
        f"max_state_diff_vs_bandpoints={diff:.3e} bound={STATE_ATOL:.0e} "
        f"seconds={time.perf_counter() - t0:.3f}")
    if not res_e < 1e-8 or diff > STATE_ATOL:
        raise AssertionError(f"{name}: bandpoints and ell disagree")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    smi = smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda", 0)

    from csparse3_tpu_torch.kernels.bandpoints import load_cuda_library
    from csparse3_tpu_torch.native import host_ext

    t0 = time.perf_counter()
    load_cuda_library()
    t1 = time.perf_counter()
    host_ext.load()
    t2 = time.perf_counter()
    log(f"build: nvcc_bandpoints_s={t1 - t0:.2f} gxx_host_ext_s={t2 - t1:.2f}")

    from csparse3_tpu_torch.models.grids import ieee14, synthetic_grid

    with torch.inference_mode():
        k = kernel_phase(dev)
        launches = newton_case("synthetic10k", synthetic_grid(10_000, seed=3),
                               dev, solves=3, profile_solve=True)
        newton_case("ieee14", ieee14(), dev)

    log(json.dumps({"kernels": [{
        "name": "bandpoints_spmv", "route": "cuda",
        "source": "csparse3_tpu_torch/csrc/bandpoints.cu",
        "replaces": "csparse3_tpu/kernels/bandpoints.py:546",
        "launches": launches, "max_abs_err": k["abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
