"""Device records (kernels, copies, sets) of the traced slice per
snapshot; missing where the profiler lost records of a kernel the program
counts."""


def read(ctx):
    t = ctx["trace"]
    if ctx["item"] != "snapshot" or t is None or not all(
            t["complete"].values()):
        return None
    return t["launches"] / ctx["items"]
