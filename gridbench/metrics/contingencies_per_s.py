"""Outages screened over the whole window, flows and flags on the host,
over the window's seconds."""


def read(ctx):
    if ctx["item"] != "outage" or not ctx["window_s"]:
        return None
    return ctx["items"] / ctx["window_s"]
