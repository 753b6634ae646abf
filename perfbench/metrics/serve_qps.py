"""Requests answered inside the window, over the window's seconds."""


def read(run):
    return len(run.answered()) / run.window.seconds
