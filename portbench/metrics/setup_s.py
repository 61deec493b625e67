"""setup_s: from process start to the first family of the window: imports,
the CUDA context, loading (or on a checkout's first run building) the
kernel library, and one warm family of the cell's traffic."""


def read(run):
    return run.setup_s
