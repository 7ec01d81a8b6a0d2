"""GMRES iterations a step, from run_bd's trajectory counter ``iters``."""


def read(t):
    return t.iters / t.steps if t.steps else None
