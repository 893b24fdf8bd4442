"""Seconds of the first prove of the process (the first warm-up prove)."""


def read(run):
    return run.warm_prove_s
