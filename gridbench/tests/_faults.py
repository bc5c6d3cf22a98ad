"""Faults planted in the program's objects after a study's set-up, for the
card tests: each study file that ``plant`` writes subclasses a real study
and breaks it underneath before the window.

* ``unchanged``: a step that returns its state unchanged;
* ``half``: half of the batch left out, the mean of the other half in its
  place;
* ``altered``: an answer altered where it is produced (one row of the
  Ybus product, or the flow factor of the branch that carries most).

No cell spans chips, so the exchange between chips has no fault to plant.
"""

import os

import torch

from _tiny import write


def _unchanged(study):
    if hasattr(study, "dc"):
        rp = study.dc._rp
        real = rp.refactor

        def refactor(data, with_diag=False):
            plan, d = real(data, with_diag=True)
            return (lambda b: torch.zeros_like(b)), d

        rp.refactor = refactor
    elif hasattr(study.pf, "_step"):
        study.pf._step = lambda carry: carry
    else:
        rp = study.pf._rp
        rp.solve_piv = lambda fac, b: torch.zeros_like(b)


def _mean(t, k):
    return torch.cat([t, t.double().mean(0, keepdim=True).to(t.dtype)
                      .expand(k - len(t), *t.shape[1:])])


def _half(study):
    if hasattr(study, "dc"):
        real = study.dc.run

        def run(outages, batch=None):
            h = len(outages) // 2
            fl, th, ok = real(outages[:h], batch=h)
            return _mean(fl, len(outages)), th, torch.ones(
                len(outages), dtype=torch.bool, device=fl.device)

        study.dc.run = run
    else:
        real = study.pf.solve_batch

        def solve_batch(sb):
            h = len(sb) // 2
            return tuple(_mean(t, len(sb)) for t in real(sb[:h]))

        study.pf.solve_batch = solve_batch


def _altered(study):
    if hasattr(study, "dc"):
        dc = study.dc
        th = dc.base_theta()
        f, t = (torch.as_tensor(dc.grid.f), torch.as_tensor(dc.grid.t))
        flow = dc._binv_x * (th[f.to(th.device)] - th[t.to(th.device)])
        dc._binv_x[int(flow.abs().argmax())] *= 1.001
        return
    plan = study.pf._yplan
    real = plan.forward

    def forward(xr, xi):
        yr, yi = real(xr, xi)
        yr = yr.clone()
        yr[..., 7] += 0.05
        return yr, yi

    plan.forward = forward


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def plant(root, study, fault):
    """Write ``studies/<study>_<fault>.py`` under ``root``: the study
    ``study`` with ``fault`` planted after its set-up.  Returns its name."""
    name = f"{study}_{fault}"
    write(os.path.join(root, "gridbench", "studies", f"{name}.py"),
          "import _faults\n"
          "from gridbench.spec import study_module\n\n"
          f"_base = study_module({study!r})\n"
          "numbers = _base.numbers\n\n\n"
          "class Study(_base.Study):\n"
          "    def __init__(self, *args):\n"
          "        super().__init__(*args)\n"
          f"        _faults.FAULTS[{fault!r}](self)\n")
    return name
