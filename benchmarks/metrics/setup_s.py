"""setup_s (s): loading the port, building or loading its kernels, making the
cell's fixed inputs and one warm-up job of the cell's shapes."""


def read(ctx):
    return ctx.setup_s
