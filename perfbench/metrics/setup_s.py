"""Seconds from the harness's start to the window's: imports, the graph,
the query pool, the weights, the kernels' build and load, warm-up."""


def read(run):
    return run.setup_s
