"""K4 (the batched split-complex DIA kernel, ``dia_entries_split_kernel``):
the least bytes of one product of the batch (float64 values; the stored
triangle where the cell's product is 'symdia') over the published
bandwidth, divided by the profiler's device time per launch, in %.
Missing where the profiler's count of the kernel differs from the
program's."""

from gridbench.reference.network import ybus
from gridbench.roofline import roofline_pct, spmv_least_bytes
from gridbench.trace import kernel_time

KERNEL = "dia_entries_split_kernel"


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["complete"].get(KERNEL):
        return None
    count, secs = kernel_time(t, KERNEL)
    if not count:
        return None
    sym = ctx["settings"]["solver"]["spmv"] == "symdia"
    nbytes = spmv_least_bytes(ybus(ctx["arrays"]), ctx["batch"], 8, sym)
    return roofline_pct(nbytes, secs / count, ctx["kind"])
