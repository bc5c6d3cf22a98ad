"""Run one cell of the port's benchmark once and print its result line.

    python3 gridbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
the program (``csparse3_tpu_torch``, with the ``native/`` sources it
builds).  The program builds its kernels into its own directory inside the
checkout at first use.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines of standard error repeat the
checks.  The run needs as many CUDA cards as the cell asks for and exits
non-zero without printing a result when they are missing, when the
program is not in the checkout, or when JAX or the JAX package was loaded.

The process keeps one host thread for its math libraries: the study's host
work is launches and copies, and idle worker threads of a pool only
contend with it (the n1 cell's rate spread 18% over six runs with the
default pools and 6% with one thread, on one H100 host).
"""

import time

T0 = time.time()  # process start, as near as Python can take it

import os  # noqa: E402

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def fail(msg: str, code: int = 2):
    print(f"gridbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gridbench.guard import forbidden_modules

    if forbidden_modules():
        fail(f"loaded before the run: {forbidden_modules()}", 3)
    from gridbench.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark measures the card and never "
             "times the CPU")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} visible")
    try:
        import csparse3_tpu_torch
    except ImportError as e:
        fail(f"the program is not in the checkout: {e}")
    if not os.path.abspath(csparse3_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        fail(f"the program at {csparse3_tpu_torch.__file__} is not the "
             f"checkout's ({ROOT})")
    from gridbench.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0,
                      log=lambda line: print(f"gridbench: {line}",
                                             file=sys.stderr, flush=True))
    bad = forbidden_modules()
    if bad:
        fail(f"loaded during the run: {bad}", 3)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
