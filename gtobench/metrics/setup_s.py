"""Set-up: the program built, the inputs drawn, one warm-up call (host clock)."""


def read(run):
    return run.setup_s
