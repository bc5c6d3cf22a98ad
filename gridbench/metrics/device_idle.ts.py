"""Share of the traced slice's wall time in which no operation ran on the
card, in %."""


def read(ctx):
    t = ctx["trace"]
    if ctx["item"] != "snapshot" or t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
