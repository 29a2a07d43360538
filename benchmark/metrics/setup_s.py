"""Seconds from the process's start to the window's first query:
imports, the kernel library, data, the engine and the warm-up."""


def read(run):
    return run.setup_s
