"""Mean iterations of the traced slice's snapshots, as ``solve_batch``
returns them."""


def read(ctx):
    it = ctx.get("iterations")
    if ctx["item"] != "snapshot" or it is None or not len(it):
        return None
    return float(it.mean())
