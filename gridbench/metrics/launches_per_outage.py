"""Device records (kernels, copies, sets) of the traced slice per
outage."""


def read(ctx):
    t = ctx["trace"]
    if ctx["item"] != "outage" or t is None or not all(
            t["complete"].values()):
        return None
    return t["launches"] / ctx["items"]
