"""AC snapshots solved over the whole window, their results on
the host, over the window's seconds."""


def read(ctx):
    if ctx["item"] != "snapshot" or not ctx["window_s"]:
        return None
    return ctx["items"] / ctx["window_s"]
