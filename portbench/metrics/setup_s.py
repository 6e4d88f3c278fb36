"""``setup_s``: seconds from the process's start to the window's start (host clock)."""


def read(run):
    return run.setup_s
