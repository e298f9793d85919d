"""setup_s (s, host clock): the run's first line to the end of the warm-up."""


def read(run):
    return run.setup_s
