"""Process start to window start: imports, the kernel libraries (built in
a checkout's first run), the key (made in its first run, else loaded),
the statement pool and the warm-up proves."""


def read(run):
    return run.setup_s
