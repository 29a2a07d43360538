"""Queries completed in the window over the window's seconds."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.completed / run.window_s
