"""Host self time of the program's ``front.factor`` and ``front.solve``
spans (``MultifrontalLU.factor_piv`` / ``solve_piv``: the front loop's
dispatch), as a share of the traced slice's wall time, in %.  Missing
where the program records no spans."""

from gridbench.spans import in_frame, recorded, self_share

NAMES = ("front.factor", "front.solve")


def read(ctx):
    t, spans = ctx["trace"], recorded()
    if ctx["item"] != "snapshot" or t is None or not spans:
        return None
    return self_share(in_frame(spans), NAMES, t["window_s"])
