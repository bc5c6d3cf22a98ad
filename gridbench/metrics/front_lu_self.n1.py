"""Host self time of the program's ``front.factor`` and ``front.retarget``
spans (``MultifrontalRefactor.factor_values`` and
``retarget_solve_plan``: the batched refactor's dispatch), as a share of
the traced slice's wall time, in %.  Missing where the program records
no spans."""

from gridbench.spans import in_frame, recorded, self_share

NAMES = ("front.factor", "front.retarget")


def read(ctx):
    t, spans = ctx["trace"], recorded()
    if ctx["item"] != "outage" or t is None or not spans:
        return None
    return self_share(in_frame(spans), NAMES, t["window_s"])
