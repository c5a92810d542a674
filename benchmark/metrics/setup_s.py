"""Seconds from the process's start (the first line of run.py) to the first
timed request: imports, the CUDA context, the kernel library, the inputs,
the program's standing state, the warm-up."""


def read(ctx):
    return ctx.setup_s
