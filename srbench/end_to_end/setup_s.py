"""Seconds from the process's start to the first timed call: imports,
inputs and weights from the seed, the program's build and load, and the
warm-up of every shape the cell uses."""


def read(ctx):
    return ctx.setup_s
