"""Seconds from process start to the end of the warm batch: context,
kernel libraries from the build directory, grid, plans, host
factorizations, traffic pool and one batch at the cell's own size."""


def read(ctx):
    return ctx["setup_s"]
